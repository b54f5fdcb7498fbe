// FAST-9/16 score + 3x3 NMS + raw arc score + 7x7 sigma=2 Gaussian blur for
// every image x pyramid level, in one launch; and the FAST score + NMS alone
// of one image with the K5 border rules.
//
// fast_pyramid_kernel replaces three TPU kernels of
// orb_slam2_detailed_comments_tpu/ops/pallas_fast.py, which compute the same
// maps: fast_pyramid_pallas_roll (K1), fast_pyramid_pallas (K3) and, for one
// image and one level, fast_score_nms_raw_pallas (K4). Same threshold, the
// same 3-px border rule and the same NMS tie-break (> against the
// scan-order-earlier neighbours, >= against the later ones, so the first
// pixel of a plateau wins, as ops/fast.py::nms_3x3 does); the raw ring is
// read from the reflect-101 halo, as the TPU kernels read it; the blur sums
// its taps k0..k6 (K3's and XLA's order; K1 sums the centre tap first) with
// rounded multiplies and adds (__fmul_rn/__fadd_rn: no FMA contraction), so
// every map agrees bit for bit with ops/fast_pyramid.py::fast_pyramid_plain.
//
// What bounds it on an H100: at KITTI size (2 images x 8 levels, level 0
// 376x1241, ~2.8 Mpx in all) it reads each level pixel once and writes three
// maps: ~45 MB, ~13 us of HBM time, with ~340 min/max/add per pixel of ALU
// work (~14 us at the f32 peak) beside it. Design: one block per 32x16
// output tile of one (image, level), found through a tile table, so one
// launch covers the whole pyramid. The level tile plus a 4-px halo is staged
// in shared memory with reflect-101 index arithmetic at the image edge; the
// thresholded score of the tile plus 1 px goes to shared memory for the NMS;
// the blur runs horizontally into shared memory, then vertically. The TPU
// kernel's rolls and aligned block writes were Mosaic workarounds and have
// no counterpart here.
//
// fast_nms_kernel replaces fast_score_nms_pallas (K5, body _fast_nms_kernel):
// the ring is read from an EDGE (clamped) halo, the thresholded score of the
// tile + 1 px is NOT zeroed in the 3-px border before the NMS, and only the
// NMS output, border zeroed, is written. It is bound like the pyramid kernel
// (8 bytes and ~310 operations per pixel) and has the same tile design.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;             // output tile width (one warp per row)
constexpr int TH = 16;             // output tile height
constexpr int HALO = 4;            // ring radius 3 + 1 px for the NMS
constexpr int SW = TW + 2 * HALO;  // staged image tile
constexpr int SH = TH + 2 * HALO;
constexpr int CW = TW + 2;         // score tile: output tile + 1 px
constexpr int CH = TH + 2;
constexpr int BR = 3;              // blur radius (7 taps)
constexpr int NT = TW * TH;        // threads per block

// FAST-16 Bresenham ring, (dy, dx), top then clockwise (ops/fast.py)
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return clamp_index(i, n);
}

// max over the 16 circular arcs of 9 of the arc's min; sign flips polarity
template <int SIGN>
__device__ __forceinline__ float arc_score(const float (&d)[16]) {
  float best;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float m = SIGN * d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) m = fminf(m, SIGN * d[(s + j) & 15]);
    best = s == 0 ? m : fmaxf(best, m);
  }
  return best;
}

// raw arc score of the staged pixel (sy, sx): both polarities
__device__ __forceinline__ float ring_score(const float (&img_s)[SH][SW], int sy, int sx) {
  const float c = img_s[sy][sx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = img_s[sy + RING_DY[k]][sx + RING_DX[k]] - c;
  return fmaxf(arc_score<1>(d), arc_score<-1>(d));
}

// 3x3 NMS at output pixel (ly, lx) of a score tile with a 1-px margin:
// strictly above the earlier neighbours, at least the later ones
__device__ __forceinline__ float nms_at(const float (&score_s)[CH][CW], int ly, int lx) {
  const float c = score_s[ly + 1][lx + 1];
  const float earlier = fmaxf(fmaxf(score_s[ly][lx], score_s[ly][lx + 1]),
                              fmaxf(score_s[ly][lx + 2], score_s[ly + 1][lx]));
  const float later = fmaxf(fmaxf(score_s[ly + 1][lx + 2], score_s[ly + 2][lx]),
                            fmaxf(score_s[ly + 2][lx + 1], score_s[ly + 2][lx + 2]));
  return (c > 0.f && c > earlier && c >= later) ? c : 0.f;
}

// entries[e] = (offset, H, W, 0) of one (image, level) in the flat buffers;
// tiles[t] = (entry, y0, x0, 0) of one 32x16 output tile.
__global__ void __launch_bounds__(NT)
fast_pyramid_kernel(const float* __restrict__ src, const int4* __restrict__ entries,
                    const int4* __restrict__ tiles, const float* __restrict__ gk,
                    float threshold, float* __restrict__ nms,
                    float* __restrict__ raw, float* __restrict__ blur) {
  __shared__ float img_s[SH][SW];
  __shared__ float score_s[CH][CW];
  __shared__ float h_s[TH + 2 * BR][TW];

  const int4 tile = tiles[blockIdx.x];
  const int4 e = entries[tile.x];
  const int off = e.x, H = e.y, W = e.z;
  const int y0 = tile.y, x0 = tile.z;
  const float* img = src + off;
  const int tid = threadIdx.y * TW + threadIdx.x;

  float g[2 * BR + 1];
#pragma unroll
  for (int k = 0; k <= 2 * BR; ++k) g[k] = gk[k];

  // 1) level tile + halo, reflect-101 at the image edge
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i % SW;
    const int gy = reflect101(y0 - HALO + ly, H);
    const int gx = reflect101(x0 - HALO + lx, W);
    img_s[ly][lx] = img[gy * W + gx];
  }
  __syncthreads();

  // 2) raw arc score; thresholded score, zero in the 3-px border, for the
  //    tile + 1 px (the NMS neighbourhood)
  for (int i = tid; i < CH * CW; i += NT) {
    const int cy = i / CW, cx = i % CW;
    const int gy = y0 - 1 + cy, gx = x0 - 1 + cx;
    const float r = ring_score(img_s, cy + HALO - 1, cx + HALO - 1);
    const bool inb = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
    score_s[cy][cx] = (inb && r > threshold) ? r : 0.f;
    if (cy >= 1 && cy <= TH && cx >= 1 && cx <= TW && gy < H && gx < W)
      raw[off + gy * W + gx] = r;
  }

  // 3) horizontal blur pass over rows y0-3 .. y0+TH+2 of the tile columns
  for (int i = tid; i < (TH + 2 * BR) * TW; i += NT) {
    const int r = i / TW, cx = i % TW;
    const float* row = &img_s[r + HALO - BR][cx + HALO - BR];
    float acc = __fmul_rn(g[0], row[0]);
#pragma unroll
    for (int k = 1; k <= 2 * BR; ++k) acc = __fadd_rn(acc, __fmul_rn(g[k], row[k]));
    h_s[r][cx] = acc;
  }
  __syncthreads();

  const int ly = threadIdx.y, lx = threadIdx.x;
  const int gy = y0 + ly, gx = x0 + lx;
  if (gy >= H || gx >= W) return;

  // 4) 3x3 NMS
  nms[off + gy * W + gx] = nms_at(score_s, ly, lx);

  // 5) vertical blur pass
  float acc = __fmul_rn(g[0], h_s[ly][lx]);
#pragma unroll
  for (int k = 1; k <= 2 * BR; ++k) acc = __fadd_rn(acc, __fmul_rn(g[k], h_s[ly + k][lx]));
  blur[off + gy * W + gx] = acc;
}

// One 32x16 output tile of one (H, W) image per block (grid = tiles in x, y).
__global__ void __launch_bounds__(NT)
fast_nms_kernel(const float* __restrict__ img, int H, int W, float threshold,
                float* __restrict__ nms) {
  __shared__ float img_s[SH][SW];
  __shared__ float score_s[CH][CW];

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // 1) tile + halo, edge-clamped at the image edge
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i % SW;
    img_s[ly][lx] = img[clamp_index(y0 - HALO + ly, H) * W + clamp_index(x0 - HALO + lx, W)];
  }
  __syncthreads();

  // 2) thresholded score of the tile + 1 px, border included
  for (int i = tid; i < CH * CW; i += NT) {
    const int cy = i / CW, cx = i % CW;
    const float r = ring_score(img_s, cy + HALO - 1, cx + HALO - 1);
    score_s[cy][cx] = r > threshold ? r : 0.f;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  // 3) 3x3 NMS, then the 3-px border zeroed
  const bool inb = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
  nms[gy * W + gx] = inb ? nms_at(score_s, threadIdx.y, threadIdx.x) : 0.f;
}

}  // namespace

extern "C" int fast_pyramid_launch(const float* src, const int* entries, const int* tiles,
                                   int n_tiles, const float* gauss7, float threshold,
                                   float* nms, float* raw, float* blur, void* stream) {
  if (n_tiles > 0) {
    fast_pyramid_kernel<<<n_tiles, dim3(TW, TH), 0, static_cast<cudaStream_t>(stream)>>>(
        src, reinterpret_cast<const int4*>(entries), reinterpret_cast<const int4*>(tiles),
        gauss7, threshold, nms, raw, blur);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fast_nms_launch(const float* img, int H, int W, float threshold, float* nms,
                               void* stream) {
  if (H > 0 && W > 0) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    fast_nms_kernel<<<grid, dim3(TW, TH), 0, static_cast<cudaStream_t>(stream)>>>(
        img, H, W, threshold, nms);
  }
  return static_cast<int>(cudaGetLastError());
}
