// FAST-9 corner score fused with a strict 3x3 non-maximum suppression, for
// every level of an image pyramid in one launch.
//
// Replaces pyslam_tpu/ops/pallas_fast.py::fast_score_map_pallas (Pallas body
// _fast_nms_kernel), which the JAX package calls once per image and level.
//
// What it computes, per pixel p of each (H, W) float32 image of each level:
//   - the FAST-9 score over the 16-point Bresenham circle of radius 3: for
//     the bright differences (circle - centre) and the dark differences
//     (centre - circle), the max over the 16 start positions of the min over
//     9 consecutive circle points; the score is the larger of the two;
//   - a score <= threshold becomes 0;
//   - pixels closer than `border` to an image edge are 0, BEFORE the NMS;
//   - p keeps its score only if it is strictly greater than all 8 neighbours.
// The result is bit-identical to the plain PyTorch version
// (pyslam_tpu_torch/ops/fast.py: fast_score_map + nms3x3), for the reasons
// given at each step below.
//
// Bound.  A 376x1241 stereo pair has 2.89 M pixels over 8 levels: 23.1 MB
// read and written once, 6.9 us at 3.35 TB/s.  Evaluating the score at
// every pixel would take ~160 float32 min/max/sub operations a pixel (0.47
// G, ~14 us at 33.5 T such operations a second), so the design cuts the
// operations until the bytes set the bound:
//   (a) the subtraction is hoisted out of the min/max: rounding x - c is
//       monotone in x, so max_k min_j fl(n - c) = fl(max_k min_j n - c),
//       and the dark side is fl(c - min_k max_j n): 2 subtractions, not 32;
//   (b) the min (max) over each 9-arc is built by doubling, r2, r4, r8,
//       then r9 (as the Pallas kernel does): 64 operations a side, not 128;
//   (c) an exact compass pretest, per side: any 9-arc of the 16-ring holds
//       two neighbouring points of 0, 4, 8, 12 (0 and 4, 4 and 8, 8 and 12
//       or 12 and 0), so a side where no such pair satisfies fl(n - c) > th
//       (bright) or fl(c - n) > th (dark) scores <= th on that side and is
//       not evaluated; a pixel where neither side passes scores 0;
//   (d) each warp compacts the (pixel, side) pairs of its rows that pass
//       into a queue in shared memory and then evaluates the queue with all
//       32 lanes: on the main path's frame 31.5 % of the interior pixels
//       pass on some side, spread along edges so that most 32-pixel warp
//       rows hold one, and a skip taken per warp row would save little;
//   (e) nothing is evaluated inside the zeroed border.
// With (c)-(e) the frame needs ~0.12 G operations (3.7 us), under the bytes.
// The loads are plain coalesced loads into shared memory, all of a thread's
// issued before any is stored; each level is fresh in the 50 MB L2 (the
// pyramid was just written) and the halo costs 1.43x the reads of a tile.
// TMA is not used: it needs global row strides that are multiples of 16
// bytes, which 7 of the 8 level widths are not (1241, 1034, 862, 718, 598,
// 499, 346 floats).
//
// Launches: one for the whole pyramid.  The level table (input and output
// pointers, sizes, first block of each level) is passed by value as a
// __grid_constant__ parameter; each block finds its level there.
//
// Layout: a block of 32x8 threads owns a 30x62 output tile of one image.
// It stages the tile plus a 4-pixel halo (3 for the circle, 1 for the NMS
// neighbours) in shared memory, zero-filled outside the image.  The score
// region is the tile plus its 1-pixel ring, 32x64: warp w owns rows
// 8w..8w+7, each lane one column.  A lane runs the pretest down its 8 rows,
// keeping its column in registers (30 shared loads for 8 pixels, not 40);
// the warp queues what passes, then evaluates its bright queue and its
// dark queue (17 shared loads and ~80 operations an entry) into its rows
// of the score region.  After a barrier each lane writes the NMS of its 8
// rows, reading the 8 neighbours from shared memory.  (Holding three
// columns in registers instead, with the row index clamped at the ends of
// the region, compiled in some variants of this source to a map shifted
// one row up; correct with ptxas -O0.  The direct reads are not slower.)
// Zero fill is exact: a pixel whose circle or NMS window would
// leave the image lies in the border (border >= 4 is checked by the
// wrapper), so its score is 0 whatever the fill, and a 0 is never kept by
// the NMS.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int TX = 32;                 // threads in x: one score column each
constexpr int TY = 8;                  // warps
constexpr int NT = TX * TY;
constexpr int RUN = 8;                 // score rows per thread
constexpr int SW = TX;                 // score region: 32 x 64
constexpr int SH = TY * RUN;
constexpr int OW = SW - 2;             // output tile: 30 x 62
constexpr int OH = SH - 2;
constexpr int RAD = 3;                 // circle radius
constexpr int IW = SW + 2 * RAD;       // staged image: 38 x 70
constexpr int IH = SH + 2 * RAD;

struct Level {
  const float* in;
  float* out;
  int h, w;
  int tiles_x;          // output tiles across
  int tiles_per_image;  // tiles_x * tiles down
  int first_block;      // first block of this level in the grid
};

struct Pyramid {
  Level lv[kMaxLevels];
  int n_levels;
  float threshold;
  int border;
};

template <bool kMin>
__device__ __forceinline__ float pick(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

// (b) kBright: the max over the 16 9-arcs around s_img[cy][cx] of the arc's
// minimum; otherwise the min over the arcs of the arc's maximum.
template <bool kBright>
__device__ __forceinline__ float arc_extreme(const float (*s_img)[IW], int cy, int cx) {
  // circle offsets, clockwise from the top (folded away by the unrolling)
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  float n[16], r2[16], r4[16], r8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) n[k] = s_img[cy + kDy[k]][cx + kDx[k]];
#pragma unroll
  for (int k = 0; k < 16; ++k) r2[k] = pick<kBright>(n[k], n[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) r4[k] = pick<kBright>(r2[k], r2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) r8[k] = pick<kBright>(r4[k], r4[(k + 4) & 15]);
  float e = pick<kBright>(r8[0], n[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) e = pick<!kBright>(e, pick<kBright>(r8[k], n[(k + 8) & 15]));
  return e;
}

__global__ void __launch_bounds__(NT, 4)
fast_nms_pyramid_kernel(const __grid_constant__ Pyramid p) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_score[SH][SW];
  // per warp and side, the (pixel, side) pairs of its rows that passed
  __shared__ unsigned short s_queue[TY][2][RUN * TX];

  int l = 0;
  while (l + 1 < p.n_levels && static_cast<int>(blockIdx.x) >= p.lv[l + 1].first_block)
    ++l;
  const Level& lv = p.lv[l];
  const int h = lv.h, w = lv.w, border = p.border;
  const float th = p.threshold;
  const int rel = blockIdx.x - lv.first_block;
  const int b = rel / lv.tiles_per_image;
  const int t = rel - b * lv.tiles_per_image;
  const int oy0 = (t / lv.tiles_x) * OH;
  const int ox0 = (t % lv.tiles_x) * OW;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* __restrict__ src = lv.in + b * plane;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TX + lane;

  // stage the tile + halo (image origin of s_img[0][0]: (oy0-4, ox0-4));
  // all of a thread's loads are issued before any is stored
  constexpr int kLoads = (IH * IW + NT - 1) / NT;
  float v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = tid + k * NT;
    const int ly = i / IW, lx = i - (i / IW) * IW;
    const int gy = oy0 - RAD - 1 + ly, gx = ox0 - RAD - 1 + lx;
    v[k] = (i < IH * IW && gy >= 0 && gy < h && gx >= 0 && gx < w)
               ? __ldg(src + gy * w + gx) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = tid + k * NT;
    if (i < IH * IW) s_img[i / IW][i - (i / IW) * IW] = v[k];
  }
  __syncthreads();

  // (c) pretest of one column of the score region, rows y0..y0+7 (image
  // origin of s_score[0][0]: (oy0-1, ox0-1); its circle centre is
  // s_img[3][3]), queued per warp; fl(c - n) == -fl(n - c) exactly
  const int sx = lane;
  const int y0 = warp * RUN;
  const int gx = ox0 - 1 + sx;
  const bool col_in = gx >= border && gx < w - border;
  const unsigned lanes_below = (1u << lane) - 1u;
  int n_bright = 0, n_dark = 0;        // this warp's queue lengths
  float col[RUN + 2 * RAD];            // s_img column sx+3, rows y0..y0+13
#pragma unroll
  for (int i = 0; i < RUN + 2 * RAD; ++i) col[i] = s_img[y0 + i][sx + RAD];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int sy = y0 + i, gy = oy0 - 1 + sy;
    const float c = col[i + RAD];
    const float d0 = col[i] - c;                          // (-3, 0)
    const float d4 = s_img[sy + RAD][sx + 2 * RAD] - c;   // (0, +3)
    const float d8 = col[i + 2 * RAD] - c;                // (+3, 0)
    const float d12 = s_img[sy + RAD][sx] - c;            // (0, -3)
    const bool in = col_in && gy >= border && gy < h - border;
    const bool b0 = d0 > th, b4 = d4 > th, b8 = d8 > th, b12 = d12 > th;
    const bool k0 = d0 < -th, k4 = d4 < -th, k8 = d8 < -th, k12 = d12 < -th;
    const bool bright = in && ((b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0));
    const bool dark = in && ((k0 && k4) || (k4 && k8) || (k8 && k12) || (k12 && k0));
    s_score[sy][sx] = 0.0f;
    const unsigned mb = __ballot_sync(0xffffffffu, bright);
    const unsigned md = __ballot_sync(0xffffffffu, dark);
    const unsigned short pix = static_cast<unsigned short>(sy * SW + sx);
    if (bright) s_queue[warp][0][n_bright + __popc(mb & lanes_below)] = pix;
    if (dark) s_queue[warp][1][n_dark + __popc(md & lanes_below)] = pix;
    n_bright += __popc(mb);
    n_dark += __popc(md);
  }
  __syncwarp();

  // (a), (b), (d): the warp's queued sides, thresholded into its rows of
  // the score region
  for (int i = lane; i < n_bright; i += TX) {
    const int pix = s_queue[warp][0][i], qy = pix / SW, qx = pix % SW;
    const float s = arc_extreme<true>(s_img, qy + RAD, qx + RAD) - s_img[qy + RAD][qx + RAD];
    if (s > th) s_score[qy][qx] = s;
  }
  __syncwarp();
  for (int i = lane; i < n_dark; i += TX) {
    const int pix = s_queue[warp][1][i], qy = pix / SW, qx = pix % SW;
    const float s = s_img[qy + RAD][qx + RAD] - arc_extreme<false>(s_img, qy + RAD, qx + RAD);
    if (s > th) s_score[qy][qx] = fmaxf(s_score[qy][qx], s);
  }
  __syncthreads();

  // strict 3x3 maximum, written for the tile's inner 30 x 62
  if (sx < 1 || sx > SW - 2) return;
  float* __restrict__ dst = lv.out + b * plane;
  for (int i = 0; i < RUN; ++i) {
    const int sy = y0 + i, gy = oy0 - 1 + sy;
    if (sy < 1 || sy > SH - 2 || gy >= h || gx >= w) continue;
    const float s = s_score[sy][sx];
    float m = fmaxf(fmaxf(s_score[sy - 1][sx - 1], s_score[sy - 1][sx]),
                    fmaxf(s_score[sy - 1][sx + 1], s_score[sy][sx - 1]));
    m = fmaxf(m, fmaxf(fmaxf(s_score[sy][sx + 1], s_score[sy + 1][sx - 1]),
                       fmaxf(s_score[sy + 1][sx], s_score[sy + 1][sx + 1])));
    dst[gy * w + gx] = s > m ? s : 0.0f;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches once on `stream`, does
// not synchronise, and returns the cudaError_t of the launch (0 on success).
// All levels of a pyramid of `batch` images: level l is in[l] -> out[l],
// both (batch, h[l], w[l]) contiguous float32.
extern "C" int pyslam_fast_nms_pyramid(const float* const* in,
                                       float* const* out, const int* h,
                                       const int* w, int n_levels, int batch,
                                       float threshold, int border,
                                       cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid p{};
  p.n_levels = n_levels;
  p.threshold = threshold;
  p.border = border;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& lv = p.lv[l];
    lv.in = in[l];
    lv.out = out[l];
    lv.h = h[l];
    lv.w = w[l];
    lv.tiles_x = (w[l] + OW - 1) / OW;
    lv.tiles_per_image = lv.tiles_x * ((h[l] + OH - 1) / OH);
    lv.first_block = blocks;
    blocks += lv.tiles_per_image * batch;
  }
  fast_nms_pyramid_kernel<<<blocks, dim3(TX, TY), 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
