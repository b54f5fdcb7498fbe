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
// read with reflect-101 indices at the image edge, as the TPU kernels read
// it; the blur sums its taps k0..k6 (K3's and XLA's order; K1 sums the
// centre tap first) with rounded multiplies and adds (__fmul_rn/__fadd_rn:
// no FMA contraction), so every map agrees bit for bit with
// ops/fast_pyramid.py::fast_pyramid_plain.
//
// What bounds it on an H100: at KITTI size (2 images x 8 levels, level 0
// 376x1241, ~3 Mpx in all) it reads each level pixel once and writes three
// maps, 16 bytes a pixel, ~46 MB: ~14 us of HBM time. The arc score is
// taken by a shared min tree (m2, m4, m8, then the 9th sample: 64 min and
// 15 max per polarity, the formulation of ops/fast.py::_rolling_min_9) on
// the ring samples themselves (see arc_score), so a pixel costs
// 2 + 2 x 79 + 2 = 162 operations of the score, 9 of the NMS and 26 of the
// blur: ~10 us at the f32 peak. Measured (tools/fast_pyramid_variants.py,
// the kernel without its arc score and without its stores): the score takes
// about half the time, near the SM's FMNMX issue rate (half the FFMA rate),
// and the loads and stores, the other half, do not overlap with it.
//
// Design: one warp per 30-column x RUN-row run of output pixels of one
// (image, level), with no shared memory and no barrier. Lane l owns column
// x0 - 1 + l (lanes 0 and 31 are the NMS margin and write nothing). The
// warp walks down the rows: each step loads the next image row's 7
// columns around the lane's column (reflect-101 indices, the columns
// reflected once per warp, the row once per step) into an 8-row register
// window, takes the horizontal blur of the current row from its 7 values,
// the arc score of the window's centre row, the NMS of the row above it
// (neighbouring columns by warp shuffles, the rows above and below from a
// 3-row register window) and the vertical blur from a 7-row window of
// horizontal sums. A score is computed for RUN + 2 rows and 32 columns per
// 30 x RUN outputs (1.2x at RUN 16); each
// image pixel is loaded (RUN + 8) / RUN times per column strip, from L1
// after the first. The level rows are not 16-byte aligned (widths such as
// 1241), so loads are 4-byte, coalesced across the warp. The (image, level)
// sources are passed by value in PyramidArgs, which fast_pyramid_launch
// makes from the sources' pointers and shapes, so the pyramid is read where
// it lies and not copied per call; the warp finds its entry by a
// compare-and-select over the table (all indices known at compile time, so
// nothing goes to local memory).
//
// fast_nms_kernel replaces fast_score_nms_pallas (K5, body _fast_nms_kernel):
// the ring is read from an EDGE (clamped) halo, the thresholded score of the
// tile + 1 px is NOT zeroed in the 3-px border before the NMS, and only the
// NMS output, border zeroed, is written. Its one output needs the score
// only where it exceeds the threshold, and that is decided exactly before
// the score (early rejection): the score is > th iff some arc of 9
// contiguous ring samples has every fl(p - c) > th (bright) or every
// fl(p - c) < -th (dark; fl(c - p) = -fl(p - c)), and every arc of 9 holds
// two cardinal samples 4 apart (ring indices 0/4, 4/8, 8/12, 12/0). A pixel
// with no such pair passing in one polarity therefore has thresholded
// score exactly 0: 4 subtractions and 8 compares decide it, against the 162
// operations of the score. What bounds K5 is the score's FMNMX rate (the
// same per-pixel work as the pyramid kernel's arc score), so the redesign
// spends it only on the survivors, gathered densely: the block stages a
// 32x16 tile + 4-px halo in shared memory (1 barrier), each thread tests its
// pixels of the tile + 1 px, writes 0 for the rejected ones and appends the
// survivors to a list in shared memory (one __ballot_sync and one atomicAdd
// a warp, 1 barrier), then the threads take the list in order and write the
// survivors' thresholded scores (1 barrier), and the 3x3 NMS reads the
// score tile. A warp thus runs the score's min tree once per 32 survivors,
// not once per 32 pixels of which any one survives. The output is the
// same, bit for bit: the rejected pixels' thresholded score is 0 either
// way. ops/fast_pyramid.py::fast_nms_survivors is the same test in torch.
// Measured (tools/fast_nms_variants.py): without the arc score at all the
// kernel takes ~0.007 ms at 1241x376, the latency of staging, testing and
// three barriers; the score of the survivors adds to that in proportion to
// their share (about a third of the pixels of bench.py's image, 2% of a
// textured frame's); larger or smaller tiles were no faster.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_ENTRIES = 32;    // (image, level) pairs per launch
constexpr int RUN = 16;            // output rows per warp
constexpr int SPAN = 30;           // output columns per warp (lanes 1..30)
constexpr int WARPS = 4;           // warps per block
constexpr int BR = 3;              // blur radius (7 taps)

// K5's staged tile
constexpr int TW = 32;             // output tile width (one warp per row)
constexpr int TH = 16;             // output tile height
constexpr int HALO = 4;            // ring radius 3 + 1 px for the NMS
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int CW = TW + 2;         // score tile: output tile + 1 px
constexpr int CH = TH + 2;
constexpr int NT = TW * TH;

// FAST-16 Bresenham ring, (dy, dx), top then clockwise (ops/fast.py). Read
// only with indices known at compile time, so the offsets fold away.
__host__ __device__ constexpr int ring_dy(int k) {
  constexpr int t[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return t[k];
}
__host__ __device__ constexpr int ring_dx(int k) {
  constexpr int t[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return t[k];
}

// The (image, level) table of one launch, made by fast_pyramid_launch and
// passed by value (~1 KB of the 4 KB a kernel's parameters may take). Entry
// e covers the warp tasks from first[e] to the next entry's first (or
// n_tasks); unused entries have first = INT_MAX.
struct PyramidArgs {
  const float* src[MAX_ENTRIES];   // the (H, W) level image
  int H[MAX_ENTRIES];
  int W[MAX_ENTRIES];
  int off[MAX_ENTRIES];            // offset of its maps in the flat outputs
  int strips[MAX_ENTRIES];         // 30-column strips across the image
  int first[MAX_ENTRIES];          // first warp task of the entry
  float gauss[2 * BR + 1];
  float threshold;
};

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return clamp_index(i, n);
}

// max over the 16 circular arcs of 9 of the arc's min of x (x = p, or -p
// for the dark polarity), by the shared tree of ops/fast.py::_rolling_min_9;
// fminf/fmaxf are exact, so any grouping gives the same value
template <bool NEG>
__device__ __forceinline__ float arc_best(const float (&p)[16]) {
  float x[16], m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = NEG ? -p[i] : p[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(x[i], x[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  // the max over the arcs as a chain: each arc is folded in as it is made,
  // which keeps fewer registers live than a tree of maxes
  float best = fminf(m8[0], x[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) best = fmaxf(best, fminf(m8[i], x[(i + 8) & 15]));
  return best;
}

// The raw arc score of a pixel of value c from its 16 ring samples p, both
// polarities. ops/fast.py takes the arcs' minima of the differences p - c
// (and c - p); fl(x - c) and fl(c - x) are monotone in x, so the minimum
// of the rounded differences is the rounded difference of the minimum, and
// the same for the maximum: two subtractions replace sixteen, and the
// value is the same (a zero may differ in sign only).
__device__ __forceinline__ float arc_score(const float (&p)[16], float c) {
  return fmaxf(__fsub_rn(arc_best<false>(p), c), __fadd_rn(c, arc_best<true>(p)));
}

// One warp: output rows y0 .. y0+RUN-1, columns x0 .. x0+SPAN-1 of one
// (image, level); see the design note at the top of the file.
__global__ void __launch_bounds__(32 * WARPS)
fast_pyramid_kernel(const PyramidArgs a, int n_tasks, float* __restrict__ nms,
                    float* __restrict__ raw, float* __restrict__ blur) {
  const int task = blockIdx.x * WARPS + threadIdx.y;
  if (task >= n_tasks) return;

  const float* img = a.src[0];
  int H = a.H[0], W = a.W[0], off = a.off[0], strips = a.strips[0], t0 = a.first[0];
#pragma unroll
  for (int i = 1; i < MAX_ENTRIES; ++i) {
    if (task >= a.first[i]) {
      img = a.src[i];
      H = a.H[i];
      W = a.W[i];
      off = a.off[i];
      strips = a.strips[i];
      t0 = a.first[i];
    }
  }
  const int t = task - t0;
  const int y0 = (t / strips) * RUN;
  const int x0 = (t % strips) * SPAN;
  const int lane = threadIdx.x;
  const int xc = x0 - 1 + lane;                       // this lane's column
  const bool out_col = lane >= 1 && lane <= SPAN && xc < W;
  const bool col_in = xc >= 3 && xc < W - 3;          // the 3-px border rule
  const float th = a.threshold;

  int cx[2 * BR + 1];
#pragma unroll
  for (int k = 0; k <= 2 * BR; ++k) cx[k] = reflect101(xc - BR + k, W);
  float g[2 * BR + 1];
#pragma unroll
  for (int k = 0; k <= 2 * BR; ++k) g[k] = a.gauss[k];

  float win[8][7];   // win[s % 8][k]: image row y0 - 4 + s, column xc - 3 + k
  float hsum[7];     // hsum[s % 7]: horizontal blur of row y0 - 4 + s at xc
  float sc[3];       // sc[s % 3]: thresholded score of row y0 - 4 + s at xc

#pragma unroll
  for (int s = 0; s < RUN + 8; ++s) {
    // row s is in the window; row s + 1 is loaded now, into the slot of
    // row s - 7, so that its latency hides behind this step's work
    if (s == 0) {
      const float* row = img + reflect101(y0 - 4, H) * W;
#pragma unroll
      for (int k = 0; k <= 2 * BR; ++k) win[0][k] = __ldg(row + cx[k]);
    }
    if (s + 1 < RUN + 8) {
      const float* row = img + reflect101(y0 - 3 + s, H) * W;
#pragma unroll
      for (int k = 0; k <= 2 * BR; ++k) win[(s + 1) % 8][k] = __ldg(row + cx[k]);
    }

    // horizontal blur of rows y0-3 .. y0+RUN+2 (taps k0..k6)
    if (s >= 1 && s <= RUN + 6) {
      float h = __fmul_rn(g[0], win[s % 8][0]);
#pragma unroll
      for (int k = 1; k <= 2 * BR; ++k) h = __fadd_rn(h, __fmul_rn(g[k], win[s % 8][k]));
      hsum[s % 7] = h;
    }

    // arc score of the centre row c = s - 3 (image rows y0-1 .. y0+RUN)
    if (s >= 6) {
      const int c = s - 3;
      const int yc = y0 - 4 + c;
      float p[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) p[k] = win[(c + ring_dy(k) + 8) % 8][3 + ring_dx(k)];
      const float r = arc_score(p, win[c % 8][3]);
      const bool inb = col_in && yc >= 3 && yc < H - 3;
      sc[c % 3] = (inb && r > th) ? r : 0.f;
      if (c >= 4 && c < RUN + 4 && out_col && yc < H) raw[off + yc * W + xc] = r;

      // 3x3 NMS of the row above the centre row (output rows y0 .. y0+RUN-1)
      if (c >= 5) {
        const int yo = yc - 1;
        const float up = sc[(c - 2) % 3], mid = sc[(c - 1) % 3], dn = sc[c % 3];
        const float ul = __shfl_up_sync(0xffffffffu, up, 1);
        const float l = __shfl_up_sync(0xffffffffu, mid, 1);
        const float dl = __shfl_up_sync(0xffffffffu, dn, 1);
        const float ur = __shfl_down_sync(0xffffffffu, up, 1);
        const float rr = __shfl_down_sync(0xffffffffu, mid, 1);
        const float dr = __shfl_down_sync(0xffffffffu, dn, 1);
        const float earlier = fmaxf(fmaxf(ul, up), fmaxf(ur, l));
        const float later = fmaxf(fmaxf(rr, dl), fmaxf(dn, dr));
        if (out_col && yo < H)
          nms[off + yo * W + xc] = (mid > 0.f && mid > earlier && mid >= later) ? mid : 0.f;
      }
    }

    // vertical blur of output row s - 7 from the horizontal sums of rows
    // s-6 .. s (taps k0..k6)
    if (s >= 7 && s <= RUN + 6) {
      const int yo = y0 - 7 + s;
      float v = __fmul_rn(g[0], hsum[(s - 6) % 7]);
#pragma unroll
      for (int k = 1; k <= 2 * BR; ++k) v = __fadd_rn(v, __fmul_rn(g[k], hsum[(s - 6 + k) % 7]));
      if (out_col && yo < H) blur[off + yo * W + xc] = v;
    }
  }
}

// raw arc score of the staged pixel (sy, sx): both polarities
__device__ __forceinline__ float ring_score(const float (&img_s)[SH][SW], int sy, int sx) {
  float p[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = img_s[sy + ring_dy(k)][sx + ring_dx(k)];
  return arc_score(p, img_s[sy][sx]);
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

// True unless the staged pixel (sy, sx) has thresholded score exactly 0 by
// the cardinal test (see the note at the top of the file).
__device__ __forceinline__ bool may_pass(const float (&img_s)[SH][SW], int sy, int sx,
                                         float th) {
  const float c = img_s[sy][sx];
  const float d0 = __fsub_rn(img_s[sy + ring_dy(0)][sx + ring_dx(0)], c);
  const float d4 = __fsub_rn(img_s[sy + ring_dy(4)][sx + ring_dx(4)], c);
  const float d8 = __fsub_rn(img_s[sy + ring_dy(8)][sx + ring_dx(8)], c);
  const float d12 = __fsub_rn(img_s[sy + ring_dy(12)][sx + ring_dx(12)], c);
  const bool b0 = d0 > th, b4 = d4 > th, b8 = d8 > th, b12 = d12 > th;
  const bool k0 = d0 < -th, k4 = d4 < -th, k8 = d8 < -th, k12 = d12 < -th;
  return (b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0) ||
         (k0 && k4) || (k4 && k8) || (k8 && k12) || (k12 && k0);
}

// One 32x16 output tile of one (H, W) image per block (grid = tiles in x, y).
// At most 40 registers a thread (no spills), so three blocks fit an SM: the
// kernel is latency-bound, and at its natural 49 registers (two blocks an
// SM) it took 10-12% longer (tools/fast_nms_variants.py).
__global__ void __launch_bounds__(NT, 3)
fast_nms_kernel(const float* __restrict__ img, int H, int W, float threshold,
                float* __restrict__ nms) {
  __shared__ float img_s[SH][SW];
  __shared__ float score_s[CH][CW];
  __shared__ short survivors[CH * CW];
  __shared__ int n_survivors;

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int lane = tid & 31;

  // 1) tile + halo, edge-clamped at the image edge
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i % SW;
    img_s[ly][lx] = img[clamp_index(y0 - HALO + ly, H) * W + clamp_index(x0 - HALO + lx, W)];
  }
  if (tid == 0) n_survivors = 0;
  __syncthreads();

  // 2) the early test over the tile + 1 px: 0 for the rejected pixels, the
  // others appended to the survivor list (every warp runs every round, so
  // the ballots see full warps)
  for (int base = 0; base < CH * CW; base += NT) {
    const int i = base + tid;
    const int cy = i / CW, cx = i % CW;
    const bool in = i < CH * CW;
    const bool pass = in && may_pass(img_s, cy + HALO - 1, cx + HALO - 1, threshold);
    if (in && !pass) score_s[cy][cx] = 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    int first = 0;
    if (lane == 0 && m) first = atomicAdd(&n_survivors, __popc(m));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (pass) survivors[first + __popc(m & ((1u << lane) - 1u))] = static_cast<short>(i);
  }
  __syncthreads();

  // 3) thresholded score of the survivors
  const int n = n_survivors;
  for (int k = tid; k < n; k += NT) {
    const int i = survivors[k];
    const int cy = i / CW, cx = i % CW;
    const float r = ring_score(img_s, cy + HALO - 1, cx + HALO - 1);
    score_s[cy][cx] = r > threshold ? r : 0.f;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  // 4) 3x3 NMS, then the 3-px border zeroed
  const bool inb = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
  nms[gy * W + gx] = inb ? nms_at(score_s, threadIdx.y, threadIdx.x) : 0.f;
}

}  // namespace

// One launch over n (image, level) entries: entry e is the (H[e], W[e])
// image at src[e], and its maps are the next H[e] * W[e] floats of each
// flat output, the entries in order. gauss holds the 7 blur taps. The
// table, the tiling and the warp count are made here; an entry count
// outside 1..MAX_ENTRIES, or maps past int32 offsets, is refused.
extern "C" int fast_pyramid_launch(int n, const float* const* src, const int* H, const int* W,
                                   const float* gauss, float threshold, float* nms, float* raw,
                                   float* blur, void* stream) {
  if (n < 1 || n > MAX_ENTRIES) return static_cast<int>(cudaErrorInvalidValue);
  PyramidArgs a;
  long long off = 0;
  int tasks = 0;
  for (int e = 0; e < MAX_ENTRIES; ++e) {
    const bool used = e < n;
    a.src[e] = used ? src[e] : nullptr;
    a.H[e] = used ? H[e] : 1;
    a.W[e] = used ? W[e] : 1;
    a.off[e] = static_cast<int>(off);
    a.strips[e] = (a.W[e] + SPAN - 1) / SPAN;
    a.first[e] = used ? tasks : INT_MAX;
    if (used) {
      if (H[e] < 1 || W[e] < 1) return static_cast<int>(cudaErrorInvalidValue);
      tasks += a.strips[e] * ((H[e] + RUN - 1) / RUN);
      off += static_cast<long long>(H[e]) * W[e];
      if (off > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int k = 0; k <= 2 * BR; ++k) a.gauss[k] = gauss[k];
  a.threshold = threshold;
  fast_pyramid_kernel<<<(tasks + WARPS - 1) / WARPS, dim3(32, WARPS), 0,
                        static_cast<cudaStream_t>(stream)>>>(a, tasks, nms, raw, blur);
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
