// Multi-level deformable sampling, backward, f32 (kernel C).
//
// Replaces the Pallas TPU kernel `_kernel_bwd` of
// gedepth_tpu/ops/pallas/msda_windowed.py:898, launched by
// `msda_windowed_level_bwd_offw` (:967, pallas_call :1050) inside the custom
// VJPs `_levels_bwd` (:390), `_flanes_bwd` (:585) and `_group_bwd` (:1114).
// The TPU kernel produced only d_offsets and d_weights; the value gradient
// went through the XLA tiled VJP because Pallas could not scatter across
// overlapping windows (:880-895). Hopper scatters with atomics, so this one
// kernel emits all three gradients of the forward of csrc/msda.cu:
//
//   out[b, q, h·d + c] = Σ_l Σ_p w · Σ_ij cw_ij · v_ij[c]
//
// With g = dOut and s_ij = Σ_c g[c] · v_ij[c] (the four corner dots):
//   d_w   = Σ_ij cw_ij · s_ij
//   d_x   = w · [(1−fy)(s01 − s00) + fy (s11 − s10)]
//   d_y   = w · [(1−fx)(s10 − s00) + fx (s11 − s01)]
//   dV[corner ij][c] += w · cw_ij · g[c]      (atomicAdd)
// where corner ij is (x0 + j, y0 + i), fx = x − floor(x), fy likewise, and
// floor has zero gradient. A corner outside the level reads as zero: it adds
// nothing to d_w or d_pos and receives no dV. Its bounds are tested in float
// before any int cast, as the forward does, so far-out positions never
// reach an integer.
//
// Shapes at the train slice's full width (crop 352x704, batch 2): value
// (2, 20570, 8, 64) over levels 88x176, 44x88, 22x44, 11x22; L = 4, P = 8;
// self-attention (hi_min_level 1) 5,082 queries per sample, cross-attention
// 61,952 queries per sample (stem grid 176x352) with positions
// (2, 61952, 8, 4, 8, 2) f32 = 254 MB and grad_out (2, 61952, 512) = 254 MB.
//
// Layout: one warp per (b, q, h); lanes over the d channels (two each at
// d = 64), so each corner row is read as one coalesced 256-byte line and the
// four dots are finished by a warp shuffle reduction. What bounds it on the
// H100: the corner re-reads (L·P·4 value rows per warp, mostly L2 hits since
// neighbouring queries sample neighbouring rows) and the dV atomics, 4 per
// sample and channel, which pile up on the hot value rows that many queries
// share. Staging value windows in shared memory and summing per block before
// the atomics are later work. Atomics add in an order that changes from run
// to run, so dV's low bits do too: the kernel is not bitwise deterministic
// (d_pos and d_w are).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxChannelsPerLane = 4;  // d <= 128

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const float* __restrict__ value,
                const int* __restrict__ levels,
                const float* __restrict__ pos,
                const float* __restrict__ weight,
                const float* __restrict__ grad_out,
                float* __restrict__ d_value,
                float* __restrict__ d_pos,
                float* __restrict__ d_weight,
                int S, int Nq, int h, int d, int L, int P,
                long long total_warps) {
  const long long qh = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  if (qh >= total_warps) return;  // whole warps leave together
  const int lane = threadIdx.x % kWarp;
  const int head = (int)(qh % h);
  const long long b = qh / ((long long)h * Nq);

  const float* pp = pos + qh * L * P * 2;
  const float* wp = weight + qh * L * P;
  float* dpp = d_pos + qh * L * P * 2;
  float* dwp = d_weight + qh * L * P;
  const long long vstride = (long long)h * d;  // one value pixel
  const long long vbase = b * S * vstride + (long long)head * d;

  // this lane's channels of g = dOut[b, q, head, :]
  float g[kMaxChannelsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerLane; ++k) {
    const int c = lane + k * kWarp;
    g[k] = c < d ? grad_out[qh * d + c] : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const long long lbase = vbase + (long long)levels[3 * l + 2] * vstride;
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
      const bool in00 = y0in && x0in, in01 = y0in && x1in;
      const bool in10 = y1in && x0in, in11 = y1in && x1in;
      const long long r00 = lbase + ((long long)y0 * Wl + x0) * vstride;
      const long long r01 = r00 + vstride;
      const long long r10 = r00 + (long long)Wl * vstride;
      const long long r11 = r10 + vstride;
      const float cw00 = (1.f - fx) * (1.f - fy), cw01 = fx * (1.f - fy);
      const float cw10 = (1.f - fx) * fy, cw11 = fx * fy;

      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxChannelsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c >= d) break;
        if (in00) s00 = fmaf(g[k], value[r00 + c], s00);
        if (in01) s01 = fmaf(g[k], value[r01 + c], s01);
        if (in10) s10 = fmaf(g[k], value[r10 + c], s10);
        if (in11) s11 = fmaf(g[k], value[r11 + c], s11);
      }
      s00 = warp_sum(s00);
      s01 = warp_sum(s01);
      s10 = warp_sum(s10);
      s11 = warp_sum(s11);

      if (lane == 0) {
        dwp[s] = cw00 * s00 + cw01 * s01 + cw10 * s10 + cw11 * s11;
        dpp[2 * s] = a * ((1.f - fy) * (s01 - s00) + fy * (s11 - s10));
        dpp[2 * s + 1] = a * ((1.f - fx) * (s10 - s00) + fx * (s11 - s01));
      }

#pragma unroll
      for (int k = 0; k < kMaxChannelsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c >= d) break;
        const float ag = a * g[k];
        if (in00) atomicAdd(d_value + r00 + c, ag * cw00);
        if (in01) atomicAdd(d_value + r01 + c, ag * cw01);
        if (in10) atomicAdd(d_value + r10 + c, ag * cw10);
        if (in11) atomicAdd(d_value + r11 + c, ag * cw11);
      }
    }
  }
}

}  // namespace

// value (B, S, h, d); levels (L, 3) int32 rows (H, W, start); pos
// (B, Nq, h, L, P, 2); weight (B, Nq, h, L, P); grad_out (B, Nq, h·d);
// outputs d_value (B, S, h, d), zeroed here first, d_pos and d_weight in the
// shapes of pos and weight; all f32 contiguous, d <= 128. Two launches on
// `stream` (the memset of d_value, then the kernel); returns
// cudaGetLastError() after them.
extern "C" int msda_bwd(const float* value, const int* levels, const float* pos,
                        const float* weight, const float* grad_out,
                        float* d_value, float* d_pos, float* d_weight,
                        int B, int S, int Nq, int h, int d, int L, int P,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t value_bytes = (size_t)B * S * h * d * sizeof(float);
  cudaError_t err = cudaMemsetAsync(d_value, 0, value_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const long long total_warps = (long long)B * Nq * h;
  if (total_warps == 0 || d == 0) return (int)cudaGetLastError();
  const long long warps_per_block = kThreads / kWarp;
  const long long blocks = (total_warps + warps_per_block - 1) / warps_per_block;
  msda_bwd_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      value, levels, pos, weight, grad_out, d_value, d_pos, d_weight, S, Nq,
      h, d, L, P, total_warps);
  return (int)cudaGetLastError();
}
