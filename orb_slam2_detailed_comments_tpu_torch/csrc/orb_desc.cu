// Intensity-centroid angle + rotated 256-pair BRIEF descriptor of every
// keypoint of every image x pyramid level, in one launch, read straight from
// the level images and their blurred maps.
//
// Replaces the TPU kernel orb_slam2_detailed_comments_tpu/ops/pallas_patch.py
// ::patch_gather (body _patch_kernel) at its ORB call site together with its
// consumer, ops/orb.py::_fused_level_angles_descriptors of the JAX package:
// there each keypoint's (2, 39, 39) [level, blur] window of the edge-padded
// level was gathered into a patch tensor, and the angle and the bits were
// taken from the patch. Here no padded copy and no patch is written: the
// window is sampled in place at clamp(clamp(x, 0, W-1) + dx, 0, W-1) (and
// the same for y), which is what the edge pad of 19 and the clamped window
// start come to (a negative start wraps first: x + W + 38, as
// lax.dynamic_slice and ops/patch_gather.py do).
//
// The function is ops/orb_desc.py::orb_desc_plain's, bit for bit:
//   - IC moments in a fixed order: lane l sums column u = l - 15 down the
//     rows v = -15..15 (I*u and I*v, rounded multiply, rounded add, terms
//     outside the radius-15 circle skipped: they add 0), then a 5-step
//     shuffle tree over the 32 lanes (offsets 16, 8, 4, 2, 1; lane 31 is
//     u = 16, outside the circle, and holds 0);
//   - atan2f, cosf, sinf (no --use_fast_math: the same libdevice functions
//     as torch.atan2/cos/sin on float32 CUDA tensors);
//   - rotated offsets dx = rint(px*c - py*s), dy = rint(px*s + py*c), each
//     product and sum rounded, rint rounding half to even as torch.round;
//   - bit j of word w is pair 32 w + j (ops/hamming.py), so lane l compares
//     pair 32 k + l and __ballot_sync gives word k.
// Invalid slots get angle 0 and descriptor 0.
//
// What bounds it on an H100: bytes. Each keypoint reads ~800 level pixels
// (the circle) and 512 blurred samples in a 37x37 window, from L2 and L1
// after the first touch; what must come from memory is the union of those
// pixels over all keypoints, at most the level and blur maps (~23 MB for
// the KITTI stereo pair, ~7 us), plus 36 bytes written per slot. The
// arithmetic, ~2k operations per keypoint, is ~0.1 us at the f32 peak.
// Design: one warp per keypoint, 8 warps a block; the per-level pointers,
// shapes and slot ranges are passed by value (orb_desc_launch makes them
// from the pointers, shapes and slot counts), and a warp finds its level
// by a compare-and-select over them.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int HALF_PATCH = 15;     // IC circle radius (ops/pattern.py)
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// Per level: the (B, H, W) level images and blurred maps, and the first
// slot of the level in the concatenated keypoints (unused: INT_MAX).
struct OrbDescArgs {
  const float* img[MAX_LEVELS];
  const float* blur[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int first[MAX_LEVELS];
};

// start of a clamped window of the edge-padded axis, as its centre in the
// unpadded one: wrap a negative start by the padded length n + 2r, clamp
__device__ __forceinline__ int window_centre(int x, int n, int r) {
  return min(max(x < 0 ? x + n + 2 * r : x, 0), n - 1);
}

__global__ void __launch_bounds__(32 * WARPS)
orb_desc_kernel(const OrbDescArgs a, const int* __restrict__ xy,
                const unsigned char* __restrict__ valid, const float* __restrict__ px,
                const float* __restrict__ py, int B, int N, int r,
                float* __restrict__ angle, int* __restrict__ desc) {
  const int task = blockIdx.x * WARPS + threadIdx.y;   // b * N + j
  if (task >= B * N) return;
  const int lane = threadIdx.x;
  const int b = task / N, j = task - b * N;
  if (!valid[task]) {
    if (lane == 0) angle[task] = 0.f;
    if (lane < 8) desc[task * 8 + lane] = 0;
    return;
  }

  const float* img = a.img[0];
  const float* blr = a.blur[0];
  int H = a.H[0], W = a.W[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (j >= a.first[i]) {
      img = a.img[i];
      blr = a.blur[i];
      H = a.H[i];
      W = a.W[i];
    }
  }
  const size_t plane = static_cast<size_t>(b) * H * W;
  img += plane;
  blr += plane;
  const int xc = window_centre(xy[task * 2], W, r);
  const int yc = window_centre(xy[task * 2 + 1], H, r);

  // IC moments: lane l sums column u = l - 15 over v = -15..15
  const int u = lane - HALF_PATCH;
  const int col = min(max(xc + u, 0), W - 1);
  const float uf = static_cast<float>(u);
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int v = -HALF_PATCH; v <= HALF_PATCH; ++v) {
    if (u * u + v * v <= HALF_PATCH * HALF_PATCH + HALF_PATCH) {   // ops/pattern.py mask
      const float I = __ldg(img + min(max(yc + v, 0), H - 1) * W + col);
      m10 = __fadd_rn(m10, __fmul_rn(I, uf));
      m01 = __fadd_rn(m01, __fmul_rn(I, static_cast<float>(v)));
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_down_sync(FULL, m10, o));
    m01 = __fadd_rn(m01, __shfl_down_sync(FULL, m01, o));
  }
  m10 = __shfl_sync(FULL, m10, 0);
  m01 = __shfl_sync(FULL, m01, 0);
  const float ang = atan2f(m01, m10);
  const float c = cosf(ang), s = sinf(ang);

  int word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float val[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 256 * h + 32 * k + lane;
      const float x = __ldg(px + i), y = __ldg(py + i);
      const int dx = static_cast<int>(rintf(__fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s))));
      const int dy = static_cast<int>(rintf(__fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c))));
      val[h] = __ldg(blr + min(max(yc + dy, 0), H - 1) * W + min(max(xc + dx, 0), W - 1));
    }
    const unsigned bits = __ballot_sync(FULL, val[0] < val[1]);
    if (lane == k) word = static_cast<int>(bits);
  }
  if (lane == 0) angle[task] = ang;
  if (lane < 8) desc[task * 8 + lane] = word;
}

}  // namespace

// One launch over n levels: level l is the (B, H[l], W[l]) images img[l]
// and blurred maps blur[l], and holds the next counts[l] of the N slots.
// A level count outside 1..MAX_LEVELS, or counts that do not sum to N, is
// refused.
extern "C" int orb_desc_launch(int n, const float* const* img, const float* const* blur,
                               const int* H, const int* W, const int* counts, const int* xy,
                               const unsigned char* valid, const float* px, const float* py,
                               int B, int N, int r, float* angle, int* desc, void* stream) {
  if (n < 1 || n > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  OrbDescArgs a;
  long long slots = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const bool used = l < n;
    a.img[l] = used ? img[l] : nullptr;
    a.blur[l] = used ? blur[l] : nullptr;
    a.H[l] = used ? H[l] : 1;
    a.W[l] = used ? W[l] : 1;
    a.first[l] = used ? static_cast<int>(slots) : INT_MAX;
    if (used) {
      if (counts[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
      slots += counts[l];
    }
  }
  if (slots != N) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && N > 0) {
    orb_desc_kernel<<<(B * N + WARPS - 1) / WARPS, dim3(32, WARPS), 0,
                      static_cast<cudaStream_t>(stream)>>>(a, xy, valid, px, py, B, N, r,
                                                           angle, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
