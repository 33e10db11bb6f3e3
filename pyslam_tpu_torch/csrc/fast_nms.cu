// FAST-9 corner score fused with a strict 3x3 non-maximum suppression.
//
// Replaces pyslam_tpu/ops/pallas_fast.py::fast_score_map_pallas (Pallas body
// _fast_nms_kernel) for one pyramid level of a batch of grey images.
//
// What it computes, per pixel p of each (H, W) float32 image:
//   - the FAST-9 score over the 16-point Bresenham circle of radius 3: for
//     the bright differences (circle - centre) and the dark differences
//     (centre - circle), the max over the 16 start positions of the min over
//     9 consecutive circle points; the score is the larger of the two;
//   - a score <= threshold becomes 0;
//   - pixels closer than `border` to an image edge are 0, BEFORE the NMS;
//   - p keeps its score only if it is strictly greater than all 8 neighbours.
// Every step is a subtraction, a min/max, a compare or a select on float32,
// so the result is bit-identical to the plain PyTorch version
// (pyslam_tpu_torch/ops/fast.py: fast_score_map + nms3x3).
//
// Design: one block per (32x32 output tile, image).  The block stages the
// tile plus a 4-pixel halo (3 for the circle, 1 for the NMS neighbours) in
// shared memory, zero-filled outside the image, computes the thresholded,
// border-masked score for the 34x34 region (tile + 1) into shared memory,
// syncs, and writes the NMS result for the 32x32 tile; ragged edges are
// masked.  Zero fill is exact here: a pixel whose circle would leave the
// image lies in the border (border >= 4 is checked by the wrapper), so its
// score is 0 whatever the fill.
//
// Bound: launch overhead and memory.  At the main path's sizes (376x1241 at
// level 0, about 0.47 M pixels, 4 B read and 4 B written each per image)
// the kernel moves a few MB per launch, far below what the card's memory
// system needs microseconds for.  Batching the left and right images of a
// stereo pair into one launch (B = 2) halves the launches; one launch for
// all pyramid levels is left for later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int SPAN = TILE + 2 * HALO;   // 40: staged image side
constexpr int SREG = TILE + 2;          // 34: score side (tile + 1 ring)
constexpr int TX = 32;
constexpr int TY = 8;

__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float run9_max(const float d[16]) {
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float m = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) m = fminf(m, d[(k + j) & 15]);
    best = fmaxf(best, m);
  }
  return best;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out, int H, int W,
                                float threshold, int border) {
  __shared__ float s_img[SPAN][SPAN];
  __shared__ float s_score[SREG][SREG];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const float* src = img + static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthreads = TX * TY;

  for (int i = tid; i < SPAN * SPAN; i += nthreads) {
    const int ly = i / SPAN, lx = i % SPAN;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = src[gy * W + gx];
    s_img[ly][lx] = v;
  }
  __syncthreads();

  for (int i = tid; i < SREG * SREG; i += nthreads) {
    const int ry = i / SREG, rx = i % SREG;
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    float score = 0.0f;
    const bool inside = gy >= border && gy < H - border && gx >= border &&
                        gx < W - border;
    if (inside) {
      const int cy = ry + HALO - 1, cx = rx + HALO - 1;
      const float c = s_img[cy][cx];
      float bright[16], dark[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float n = s_img[cy + kCircleDy[k]][cx + kCircleDx[k]];
        bright[k] = n - c;
        dark[k] = c - n;
      }
      const float s = fmaxf(run9_max(bright), run9_max(dark));
      score = s > threshold ? s : 0.0f;
    }
    s_score[ry][rx] = score;
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * H * W;
  for (int ly = threadIdx.y; ly < TILE; ly += TY) {
    const int gy = y0 + ly, gx = x0 + threadIdx.x;
    if (gy >= H || gx >= W) continue;
    const int ry = ly + 1, rx = threadIdx.x + 1;
    const float s = s_score[ry][rx];
    float m = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (dy != 0 || dx != 0) m = fmaxf(m, s_score[ry + dy][rx + dx]);
    dst[gy * W + gx] = s > m ? s : 0.0f;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int pyslam_fast_nms(const float* img, float* out, int B, int H,
                               int W, float threshold, int border,
                               cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fast_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W, threshold,
                                              border);
  return static_cast<int>(cudaGetLastError());
}
