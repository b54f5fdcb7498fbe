// Clamped window gather: B (ph, pw) windows over C channels of a (C, H, W)
// stack, at int32 top-left (x, y), with lax.dynamic_slice semantics: a
// negative start counts from the end (x + W), then starts are clamped to
// [0, W-pw] x [0, H-ph]. An optional leading batch of N stacks, each with
// its own B windows.
//
// Replaces the TPU kernel orb_slam2_detailed_comments_tpu/ops/pallas_patch.py
// ::patch_gather (body _patch_kernel). The TPU kernel fetched tile-aligned
// windows by DMA and rotated them into place because Mosaic would not slice
// at arbitrary offsets, and it took square windows only; here any (ph, pw)
// is a plain strided copy.
//
// What bounds it on an H100: it is a pure copy. The SAD template and strip
// move ~2.9 MB at 2048 keypoints, so it is bound by HBM bytes and launch
// latency. (At its ORB call site, 2 x 39 x 39 floats per keypoint, the
// gather is fused with its consumer in orb_desc.cu and writes no window.)
// Design: one block per window; the threads stride over the C*ph*pw
// outputs, so stores are contiguous and each row of a window is a
// contiguous read. Fusing it into the SAD is later work.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
patch_gather_kernel(const float* __restrict__ src, const int* __restrict__ xy,
                    float* __restrict__ out, int C, int H, int W, int B, int ph, int pw) {
  const int p = blockIdx.x;
  const int n = blockIdx.y;
  const int* c = xy + (static_cast<size_t>(n) * B + p) * 2;
  const int x0 = min(max(c[0] < 0 ? c[0] + W : c[0], 0), W - pw);
  const int y0 = min(max(c[1] < 0 ? c[1] + H : c[1], 0), H - ph);
  const float* s = src + static_cast<size_t>(n) * C * H * W;
  float* o = out + (static_cast<size_t>(n) * B + p) * C * ph * pw;
  const int per = ph * pw;
  for (int i = threadIdx.x; i < C * per; i += NT) {
    const int ch = i / per, r = i - ch * per;
    const int iy = r / pw, ix = r - iy * pw;
    o[i] = s[(static_cast<size_t>(ch) * H + y0 + iy) * W + x0 + ix];
  }
}

}  // namespace

extern "C" int patch_gather_launch(const float* src, const int* xy, float* out, int n_stacks,
                                   int C, int H, int W, int B, int ph, int pw, void* stream) {
  if (n_stacks > 0 && B > 0) {
    patch_gather_kernel<<<dim3(B, n_stacks), NT, 0, static_cast<cudaStream_t>(stream)>>>(
        src, xy, out, C, H, W, B, ph, pw);
  }
  return static_cast<int>(cudaGetLastError());
}
