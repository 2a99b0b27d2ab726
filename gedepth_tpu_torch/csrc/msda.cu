// Multi-level deformable sampling, forward, f32.
//
// Replaces the Pallas TPU kernel `_kernel` of
// gedepth_tpu/ops/pallas/msda_windowed.py:112, launched by
// `_pallas_level_lanes` (:268, pallas_call :294) and `_pallas_level_flanes`
// (:486, pallas_call :509) under `msda_windowed_levels` and
// `msda_windowed_levels_flanes`; its level loop also covers what
// `_kernel_multi` (:627) fused. For each batch b, query q, head h and
// channel c:
//   out[b, q, h·d + c] = Σ_l Σ_p w[b,q,h,l,p] ·
//                        bilinear(value_l[b, :, :, h, c], pos[b,q,h,l,p])
// with zero padding outside the level (grid_sample's 'zeros' rule). The
// positions are in level pixels (x, y) with the loc·size − 0.5 convention
// already applied, so the windowed, exact and compat sampling rules differ
// only in how the caller forms them (gedepth_tpu_torch/ops/msda.py).
//
// Where the TPU had no gather, its kernel built a dense bilinear operator
// over a value window per 128-query tile and contracted it on the MXU; a
// (query grid, level) pair whose window did not fit VMEM (`_plan` None, e.g.
// the 11x38 grid sampling 88x304) went to an XLA fallback. Hopper gathers
// well, so this kernel gathers the four corners directly and takes every
// pair the same way.
//
// Shapes at the serving slice's full width (352x1216, batch 1): value
// (1, 35530, 8, 64) over levels 88x304, 44x152, 22x76, 11x38; L = 4, P = 8;
// self-attention 8,778 queries, cross-attention 107,008 queries.
//
// Bound on the H100: each output channel reads L·P·4 = 128 value floats
// and does ~3 FLOP per read, so value reads bound it (the value, 73 MB,
// barely exceeds L2, and neighbouring queries hit the same rows). One
// thread per (b, q, h, c) with c innermost makes the 4 corner reads of a
// warp 128-byte coalesced rows of one value pixel; the (q, h) sample
// positions and weights are broadcast reads within the warp. No atomics and
// no shared state between threads: the result is deterministic.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const float* __restrict__ value,
                const int* __restrict__ levels,
                const float* __restrict__ pos,
                const float* __restrict__ weight,
                float* __restrict__ out,
                int S, int Nq, int h, int d, int L, int P, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % d);
  const long long qh = idx / d;  // ((b·Nq + q)·h + head)
  const int head = (int)(qh % h);
  const long long b = qh / ((long long)h * Nq);

  const float* pp = pos + qh * L * P * 2;
  const float* wp = weight + qh * L * P;
  const long long vstride = (long long)h * d;  // one value pixel
  const float* vb = value + b * S * vstride + (long long)head * d + c;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const float* vl = vb + (long long)levels[3 * l + 2] * vstride;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const float x = pp[2 * s], y = pp[2 * s + 1];
      const float a = wp[s];
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      // bounds in float first: positions far outside never reach an int
      const bool x0in = x0f >= 0.f && x0f < (float)Wl;
      const bool x1in = x0f >= -1.f && x0f < (float)(Wl - 1);
      const bool y0in = y0f >= 0.f && y0f < (float)Hl;
      const bool y1in = y0f >= -1.f && y0f < (float)(Hl - 1);
      const int x0 = x0in || x1in ? (int)x0f : 0;
      const int y0 = y0in || y1in ? (int)y0f : 0;
      float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
      if (y0in && x0in) v00 = vl[((long long)y0 * Wl + x0) * vstride];
      if (y0in && x1in) v01 = vl[((long long)y0 * Wl + x0 + 1) * vstride];
      if (y1in && x0in) v10 = vl[((long long)(y0 + 1) * Wl + x0) * vstride];
      if (y1in && x1in) v11 = vl[((long long)(y0 + 1) * Wl + x0 + 1) * vstride];
      const float s_ = (1.f - fx) * (1.f - fy) * v00 + fx * (1.f - fy) * v01 +
                       (1.f - fx) * fy * v10 + fx * fy * v11;
      acc = fmaf(a, s_, acc);
    }
  }
  out[idx] = acc;
}

}  // namespace

// value (B, S, h, d); levels (L, 3) int32 rows (H, W, start); pos
// (B, Nq, h, L, P, 2); weight (B, Nq, h, L, P); out (B, Nq, h·d); all f32
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int msda_fwd(const float* value, const int* levels,
                        const float* pos, const float* weight, float* out,
                        int B, int S, int Nq, int h, int d, int L, int P,
                        void* stream) {
  const long long total = (long long)B * Nq * h * d;
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  msda_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      value, levels, pos, weight, out, S, Nq, h, d, L, P, total);
  return (int)cudaGetLastError();
}
