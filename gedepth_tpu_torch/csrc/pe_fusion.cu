// Adaptive ground-embedding (PE) fusion, forward, f32: one thread per pixel.
//
// Replaces the Pallas TPU kernel `_kernel` of
// gedepth_tpu/ops/pallas/pe_fusion.py:57, launched by
// `pe_fusion_pallas_fwd` (:90, pallas_call :99); the JAX model computes the
// same math as `pe_fusion_xla` (:41). Per pixel:
//   p = softmax(logits[11])          slope bins -5..+5 degrees
//   slope = Σ p·center; t = tan(slope·π/180)
//   a = -h / (pe + 1e-8); off = -h / (a - t + 1e-8)
//   out = (0 < off <= depth_scale ? off : 0) · y
//
// Shapes at the serving slice's full width: logits (1, 352, 1216, 11), pe
// and y (1, 352, 1216), h (1,).
//
// Bound on the H100: 14 floats in and 1 out per pixel against ~60 FLOP and
// one tan, so it is bound by device-memory bytes (~24 MB at full width).
// The logits are read in place in (B, H, W, 11) layout: the TPU kernel's
// (B, 11, H, W) transpose existed for its lane layout and would cost one
// more pass over them here; the 44-byte rows of neighbouring threads still
// fill whole cache lines. No atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kDeg2Rad = 0.017453292519943295f;

__global__ void __launch_bounds__(kThreads)
pe_fusion_kernel(const float* __restrict__ logits,
                 const float* __restrict__ pe,
                 const float* __restrict__ y,
                 const float* __restrict__ cam_height,
                 float* __restrict__ out,
                 long long total, int HW, int K, float depth_scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* l = logits + i * K;
  float m = l[0];
  for (int k = 1; k < K; ++k) m = fmaxf(m, l[k]);
  // bin centres are evenly spaced from -(K-1)/2 to +(K-1)/2 degrees
  const float c0 = -0.5f * (float)(K - 1);
  float s = 0.f, num = 0.f;
  for (int k = 0; k < K; ++k) {
    const float e = expf(l[k] - m);
    s += e;
    num = fmaf(e, c0 + (float)k, num);
  }
  const float t = tanf((num / s) * kDeg2Rad);
  const float h = cam_height[i / HW];
  const float a = -h / (pe[i] + 1e-8f);
  const float off = -h / ((a - t) + 1e-8f);
  const bool valid = off > 0.f && off <= depth_scale;
  out[i] = (valid ? off : 0.f) * y[i];
}

}  // namespace

// logits (B, H, W, K); pe, y, out (B, H, W); cam_height (B,); all f32
// contiguous; HW = H·W. Returns cudaGetLastError() after the launch.
extern "C" int pe_fusion_fwd(const float* logits, const float* pe,
                             const float* y, const float* cam_height,
                             float* out, int B, int HW, int K,
                             float depth_scale, void* stream) {
  const long long total = (long long)B * HW;
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  pe_fusion_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      logits, pe, y, cam_height, out, total, HW, K, depth_scale);
  return (int)cudaGetLastError();
}
