// Swin window attention, forward, f32: one block per (window, head).
//
// Replaces the Pallas TPU kernel `_forward_pallas` of
// gedepth_tpu/ops/pallas/window_attn.py:49 (pallas_call at :80 unmasked and
// :108 masked), which the JAX model reaches as `window_attention_xla`
// (gedepth_tpu/ops/window_attention.py:34): for each window w and head h,
//   out[w, :, h, :] = softmax(q kᵀ + bias[h] + mask[w mod nW]) v
// with q pre-scaled and rows of the softmax over the N = window² keys.
//
// Shapes at the serving slice's full width (Swin-L, 352x1216, batch 1):
// N = 49, D = 32, heads 6/12/24/48, and 572/154/44/12 windows per stage
// after padding each stage grid to multiples of 7; shifted blocks add the
// (nW, 49, 49) mask.
//
// Bound on the H100: per (window, head) the kernel reads 3·N·D + N² (+N²)
// floats (~35 KB) and does 4·N²·D ≈ 0.3 MFLOP, ~9 FLOP/byte, under the
// f32 CUDA-core ridge of the H100 SXM data sheet (67 TFLOP/s over
// 3.35 TB/s at 700 W ≈ 20 FLOP/byte), so the bytes bound it and everything
// between the two products stays on chip:
// q, k, v and the N×N logits live in shared memory (~29 KB at D = 32) and
// only the output goes back to device memory. Rows are padded by one float
// so that the q·k and p·v loops read shared memory without bank conflicts.
// No atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ out,
                        int N, int H, int D, int nW) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int ld = D + 1;   // padded row stride of q, k, v
  const int lds = N + 1;  // padded row stride of the logits
  float* sq = smem;
  float* sk = sq + N * ld;
  float* sv = sk + N * ld;
  float* ss = sv + N * ld;

  // element (w, n, h, d) of a (nWB, N, H, D) tensor
  const long long base = (long long)w * N * H * D + (long long)h * D;
  const long long row = (long long)H * D;

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int n = i / D, d = i - n * D;
    const long long g = base + n * row + d;
    sq[n * ld + d] = q[g];
    sk[n * ld + d] = k[g];
    sv[n * ld + d] = v[g];
  }
  __syncthreads();

  const float* bh = bias + (long long)h * N * N;
  const float* mw = mask ? mask + (long long)(w % nW) * N * N : nullptr;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, c = i - r * N;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(sq[r * ld + d], sk[c * ld + d], acc);
    acc += bh[i];
    if (mw) acc += mw[i];
    ss[r * lds + c] = acc;
  }
  __syncthreads();

  // row softmax in f32, one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < N; r += nwarps) {
    float* srow = ss + r * lds;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, srow[c]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      s += e;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int c = lane; c < N; c += 32) srow[c] = srow[c] / s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    const int n = i / D, d = i - n * D;
    const float* prow = ss + n * lds;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(prow[j], sv[j * ld + d], acc);
    out[base + n * row + d] = acc;
  }
}

}  // namespace

// q, k, v, out: (nWB, N, H, D) f32 contiguous; bias (H, N, N); mask
// (nW, N, N) or null. Returns cudaGetLastError() after the launch.
extern "C" int window_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* mask, float* out, int nWB,
                                    int N, int H, int D, int nW,
                                    void* stream) {
  const size_t smem = (size_t)(3 * N * (D + 1) + N * (N + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nWB, H);
  window_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, mask, out, N, H, D, mask ? nW : 1);
  return (int)cudaGetLastError();
}
