// FAST-9 + strict 3x3 NMS, one launch per pyramid level: the design that
// fast_nms.cu replaced.  Nothing in the package calls it; chip_smoke.py
// builds it beside fast_nms.cu and times both in the same run, so the
// one-launch kernel is always measured against it on the same card
// (`before_ms` in the kernel line).
//
// One block of 32x8 threads per (32x32 output tile, image): it stages the
// tile plus a 4-pixel halo in shared memory, computes the thresholded,
// border-masked score of the 34x34 region (tile + 1) with 16 subtractions a
// side and 16 x 8 min per side, syncs, and writes the NMS of the 32x32
// tile.  Bit-identical to the plain version for the reasons given in
// fast_nms.cu.

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
extern "C" int pyslam_fast_nms_per_level(const float* img, float* out, int B,
                                         int H, int W, float threshold,
                                         int border, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fast_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W, threshold,
                                              border);
  return static_cast<int>(cudaGetLastError());
}
