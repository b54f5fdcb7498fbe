// The 11x11 SAD refinement of the stereo matcher, one keypoint slot per
// warp: the template and strip windows, their centre normalisation, the 11
// SADs over +-5 px, the first minimum and the parabola, in one launch read
// straight from the two images.
//
// Replaces the TPU kernel orb_slam2_detailed_comments_tpu/ops/pallas_patch.py
// ::patch_gather (body _patch_kernel) at its SAD call site together with its
// consumer, the SAD stage of ops/stereo.py::_stereo_match of the JAX
// package: there the 11x11 template of the left image and the 11x21 strip
// of the right one (gathered 21x21 and sliced) were copied out of the
// edge-padded images into window tensors, and ~80 XLA ops took the SADs,
// the argmin and the parabola from them. Here no padded copy and no window
// is written: row y + r - 5 and column x + c - 5 (template) or
// x + c - 10 (strip) are read in place, clamped to the image, which is
// what the edge pad and the never-clamped window start come to.
//
// The function is ops/stereo_sad.py::stereo_sad_plain's, bit for bit:
//   - xl_i, yl_i, xr_i = clamp(rint(x)) (rint rounds half to even, as
//     torch.round); xr = xr_all[idx], and a slot whose idx lies outside
//     [0, M) gets NaN in both outputs;
//   - template and strip minus their centre pixel (rounded subtractions);
//   - SAD(o) in a fixed order: lane c (c < 11) sums |T'[r][c] - S'[r][c+o]|
//     down the rows r = 0..10 (rounded subtract, exact abs, rounded add;
//     the strip column c + o comes from lane c + o by a shuffle), then a
//     4-step shuffle tree over the lanes (offsets 8, 4, 2, 1; lanes 11..15
//     hold 0);
//   - the first minimum, om = clamp(best, 1, 9), the parabola
//     delta = (s[om-1] - s[om+1]) / (2 max(denom, 1e-6)) where |denom| >
//     1e-6 (denom = (s[om-1] + s[om+1]) - 2 s[om]), IEEE division, delta
//     clamped to +-1, u_r = (xr_i + (om - 5)) + delta.
// No multiply-add is left for the compiler to contract: every rounded
// operation is an __f*_rn intrinsic.
//
// What bounds it on an H100: at the main path's 2048 slots on a 1241x376
// pair, the pixels under the windows read once (their union, ~1.2 MB on
// bench.py's pair) and ~24 bytes of inputs and outputs per slot: ~0.35 us
// of HBM time; the 11 x 121 x 3 operations per slot, ~9 M in all, are
// ~0.13 us at the f32 peak. So it is
// bound by bytes in principle and by the latency of one small launch in
// practice. Design: one warp per slot, 8 warps a block, no shared memory.
// Lane l owns strip column l (l < 21) and template column l (l < 11); the
// 11 rows of both are loaded up front (22 independent loads a lane, 21 and
// 11 contiguous floats across the warp), so their latency overlaps; the
// 121 shuffles of the row sums need no barrier. Lane 0 takes the argmin
// and the parabola and writes the slot's two floats.
#include <cuda_runtime.h>

namespace {

constexpr int HALF = 5;                  // 11x11 template (ops/stereo_sad.py SAD_HALF)
constexpr int SLIDE = 5;                 // +-5 px search (ops/stereo_sad.py SLIDE)
constexpr int TWIN = 2 * HALF + 1;       // template width and rows: 11
constexpr int SWIN = TWIN + 2 * SLIDE;   // strip width: 21
constexpr int NOFF = 2 * SLIDE + 1;      // offsets: 11
constexpr int TREE = 16;                 // template columns padded to a power of 2
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

__global__ void __launch_bounds__(32 * WARPS)
stereo_sad_kernel(const float* __restrict__ img_l, const float* __restrict__ img_r, int H, int W,
                  const float* __restrict__ xl, const float* __restrict__ yl,
                  const float* __restrict__ xr, int M, const int* __restrict__ idx, int N,
                  float* __restrict__ u_r, float* __restrict__ best_sad) {
  const int slot = blockIdx.x * WARPS + threadIdx.y;
  if (slot >= N) return;
  const int lane = threadIdx.x;
  const int j = __ldg(idx + slot);
  if (j < 0 || j >= M) {
    if (lane == 0) {
      u_r[slot] = __int_as_float(0x7fc00000);
      best_sad[slot] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const int xli = clamp_index(static_cast<int>(rintf(__ldg(xl + slot))), W);
  const int yli = clamp_index(static_cast<int>(rintf(__ldg(yl + slot))), H);
  const int xri = clamp_index(static_cast<int>(rintf(__ldg(xr + j))), W);

  const float tc = __ldg(img_l + yli * W + xli);
  const float sc = __ldg(img_r + yli * W + xri);
  const int tcol = clamp_index(xli + lane - HALF, W);
  const int scol = clamp_index(xri + lane - HALF - SLIDE, W);
  float t[TWIN], s[TWIN];
#pragma unroll
  for (int r = 0; r < TWIN; ++r) {
    const int row = clamp_index(yli + r - HALF, H) * W;
    t[r] = lane < TWIN ? __fsub_rn(__ldg(img_l + row + tcol), tc) : 0.f;
    s[r] = lane < SWIN ? __fsub_rn(__ldg(img_r + row + scol), sc) : 0.f;
  }

  // lane c: the partial SAD of template column c at each offset o
  float acc[NOFF];
#pragma unroll
  for (int o = 0; o < NOFF; ++o) acc[o] = 0.f;
#pragma unroll
  for (int r = 0; r < TWIN; ++r) {
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
      const float v = __shfl_sync(FULL, s[r], lane + o);
      acc[o] = __fadd_rn(acc[o], fabsf(__fsub_rn(t[r], v)));
    }
  }
#pragma unroll
  for (int o = 0; o < NOFF; ++o) {
    if (lane >= TWIN) acc[o] = 0.f;
#pragma unroll
    for (int h = TREE / 2; h >= 1; h >>= 1)
      acc[o] = __fadd_rn(acc[o], __shfl_down_sync(FULL, acc[o], h));
  }
  if (lane != 0) return;

  int bo = 0;
  float best = acc[0];
#pragma unroll
  for (int o = 1; o < NOFF; ++o) {
    if (acc[o] < best) {
      best = acc[o];
      bo = o;
    }
  }
  const int om = min(max(bo, 1), NOFF - 2);
  float sm1 = 0.f, s0 = 0.f, sp1 = 0.f;
#pragma unroll
  for (int o = 0; o < NOFF; ++o) {   // selects with indices known at compile time
    if (o == om - 1) sm1 = acc[o];
    if (o == om) s0 = acc[o];
    if (o == om + 1) sp1 = acc[o];
  }
  const float denom = __fsub_rn(__fadd_rn(sm1, sp1), __fmul_rn(2.f, s0));
  float delta = fabsf(denom) > 1e-6f
                    ? __fdiv_rn(__fsub_rn(sm1, sp1), __fmul_rn(2.f, fmaxf(denom, 1e-6f)))
                    : 0.f;
  delta = fminf(fmaxf(delta, -1.f), 1.f);
  u_r[slot] = __fadd_rn(__fadd_rn(static_cast<float>(xri), static_cast<float>(om - SLIDE)), delta);
  best_sad[slot] = best;
}

}  // namespace

// N slots over a pair of (H, W) images; xr holds the M right keypoints'
// x and idx each slot's right keypoint. A negative size is refused.
extern "C" int stereo_sad_launch(const float* img_l, const float* img_r, int H, int W,
                                 const float* xl, const float* yl, const float* xr, int M,
                                 const int* idx, int N, float* u_r, float* best_sad,
                                 void* stream) {
  if (H < 1 || W < 1 || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    stereo_sad_kernel<<<(N + WARPS - 1) / WARPS, dim3(32, WARPS), 0,
                        static_cast<cudaStream_t>(stream)>>>(img_l, img_r, H, W, xl, yl, xr, M,
                                                             idx, N, u_r, best_sad);
  }
  return static_cast<int>(cudaGetLastError());
}
