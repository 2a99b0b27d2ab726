// Swin window attention, forward, bf16 on the tensor cores (the bf16
// instance of kernel A; the f32 instance is csrc/window_attention.cu).
//
// Replaces the Pallas TPU kernel `_forward_pallas` of
// gedepth_tpu/ops/pallas/window_attn.py:49 (pallas_call at :80 unmasked and
// :108 masked) on bf16 tensors, which the JAX model reaches as
// `window_attention_xla` (gedepth_tpu/ops/window_attention.py:34): for each
// window w and head h,
//   out[w, :, h, :] = softmax(q kᵀ + bias[h] + mask[w mod nW]) v
// with q pre-scaled. q, k, v and out are bf16; bias and mask are bf16 or f32
// (a model cast to bf16 holds its bias table in bf16 and builds its shift
// mask in f32). The logits, the softmax and the P·v sum are f32: the XLA
// reference rounds the logits to bf16 before the softmax, this kernel does
// not, so it is held against a float64 evaluation of the same bf16 inputs.
//
// What bounds it on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor
// cores, 700 W): per (window, head) it moves 4·N·D bf16 (12.5 KB at N = 49,
// D = 32) and does 4·N²·D FLOP (0.31 M). Stage 1 (572, 49, 6, 32): 43 MB,
// ~13 µs of bytes, against ~1 µs of tensor-core time: bytes bound it. The
// f32 instance is held by its FMAs on CUDA cores (~10x more instructions
// for the two products); here both products are `mma.sync.m16n8k16` (bf16
// in, f32 accumulate).
//
// Design:
//   - the block shape of the f32 instance: 4 warps own one head and walk
//     windows bx, bx + gridDim.x, ...; a window pads to 64 tokens and each
//     warp owns 16 query rows;
//   - a two-stage cp.async ring of the q, k, v tiles (16-byte copies) and
//     the window's mask row; rows past N are zeroed once and never filled;
//   - S = q kᵀ: A fragments of q and B fragments of k are 32-bit loads from
//     the row-major tiles (row stride D + 8 bf16, so the 8 rows x 4 words of
//     a fragment load fall in distinct banks); 8 key tiles x D/16 steps;
//   - + bias + mask and the row softmax on the accumulator fragments: a row
//     lies over the 4 lanes of a quad, so max and sum take two shuffles;
//   - P·v: the accumulator layout of S is the A-fragment layout of P, so P
//     never touches shared memory. P is fed as two bf16 terms, hi + lo
//     (lo = bf16(p − hi)): 16 mantissa bits, so the product is f32-accurate
//     and the only rounding to bf16 is the one at the store. B fragments of
//     v come from `ldmatrix.trans` on the row-major tile;
//   - the 16 x D output of a warp goes through the warp's own (spent) q
//     rows in shared memory and leaves as 16-byte stores.
// Deterministic: no atomics. Head width D is a template parameter
// (multiples of 8 up to 64; widths that are not multiples of 16 pad the
// q·k depth with the zero columns of the tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 64;   // 4 warps x 16 query rows, 8 tiles of 8 keys
constexpr int kBiasLd = 72; // floats a bias row: ≡ 8 mod 32, 8-byte aligned

// Shared-memory layout in bytes, for N tokens and head width D: a ring of
// two stages, each q, k, v (64 rows of D + 8 bf16) and the window's mask
// row (N² floats, rounded up to 16 bytes); then bias[h] as floats.
struct Layout {
  int ld, tile, stage, bytes;
  __host__ __device__ Layout(int N, int D, bool masked) {
    ld = D + 8;
    tile = kMaxN * ld * (int)sizeof(bf16);
    stage = 3 * tile + (masked ? (N * N * 4 + 15) & ~15 : 0);
    bytes = 2 * stage + N * kBiasLd * (int)sizeof(float);
  }
};

struct Strides {
  long long qw, qn, kw, kn, vw, vn;   // window and row strides, in elements
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// c += a (16 x 16, row-major fragments) · b (16 x 8, column fragments)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (16 keys x 8 channels) of a row-major v tile: lanes 0..15 give
// the addresses of the 16 key rows
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(s));
}

// rows 0..N-1 of window w, head h (and its mask row) into one ring stage
template <int D>
__device__ __forceinline__ void load_window(unsigned char* st, const Layout& L,
                                            const bf16* q, const bf16* k,
                                            const bf16* v, const void* mask,
                                            bool mask_bf16, int nW,
                                            const Strides& s, int w, int h,
                                            int N) {
  constexpr int C = D / 8;   // 16-byte chunks per row
  constexpr int ld = D + 8;
  const bf16* gq = q + w * s.qw + h * D;
  const bf16* gk = k + w * s.kw + h * D;
  const bf16* gv = v + w * s.vw + h * D;
  bf16* sq = reinterpret_cast<bf16*>(st);
  bf16* sk = sq + kMaxN * ld;
  bf16* sv = sk + kMaxN * ld;
  for (int i = threadIdx.x; i < N * C; i += kThreads) {
    const int n = i / C, c = 8 * (i - n * C);
    cp_async16(sq + n * ld + c, gq + n * s.qn + c);
    cp_async16(sk + n * ld + c, gk + n * s.kn + c);
    cp_async16(sv + n * ld + c, gv + n * s.vn + c);
  }
  if (mask) {
    float* sm = reinterpret_cast<float*>(st + 3 * L.tile);
    const long long at = (long long)(w % nW) * N * N;
    if (mask_bf16) {
      // a row of N² bf16 need not start on 4 bytes: plain loads
      const bf16* gm = static_cast<const bf16*>(mask) + at;
      for (int i = threadIdx.x; i < N * N; i += kThreads)
        sm[i] = __bfloat162float(gm[i]);
    } else {
      const float* gm = static_cast<const float*>(mask) + at;
      for (int i = threadIdx.x; i < N * N; i += kThreads)
        cp_async4(sm + i, gm + i);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
window_attention_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const void* __restrict__ bias, bool bias_bf16,
                             const void* __restrict__ mask, bool mask_bf16,
                             bf16* __restrict__ out, int nWB, int N, int H,
                             int nW, Strides s) {
  constexpr int ld = D + 8;
  constexpr int KS = (D + 15) / 16;   // depth steps of q·kᵀ
  constexpr int NT = D / 8;           // channel tiles of P·v
  constexpr int C = D / 8;            // 16-byte chunks of an output row
  const Layout L(N, D, mask != nullptr);
  extern __shared__ __align__(16) unsigned char smem[];
  float* sb = reinterpret_cast<float*>(smem + 2 * L.stage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int gr = lane >> 2, gc = lane & 3;   // fragment row and column pair
  const int r0 = warp * 16 + gr;             // this lane's rows: r0, r0 + 8
  // rows past N read the bias and mask of row N - 1: finite, never stored
  const int ra = min(r0, N - 1), rb = min(r0 + 8, N - 1);

  for (int i = threadIdx.x; i < 2 * L.stage / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < N * N; i += kThreads) {
    const int r = i / N;
    const long long at = (long long)h * N * N + i;
    sb[r * kBiasLd + i - r * N] =
        bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[at])
                  : static_cast<const float*>(bias)[at];
  }
  __syncthreads();   // zeros written before cp.async fills the rows

  int w = blockIdx.x;
  load_window<D>(smem, L, q, k, v, mask, mask_bf16, nW, s, w, h, N);
  cp_async_commit();
  for (int it = 0; w < nWB; ++it, w += gridDim.x) {
    unsigned char* st = smem + (it & 1) * L.stage;
    bf16* sq = reinterpret_cast<bf16*>(st);
    const bf16* sk = sq + kMaxN * ld;
    const bf16* sv = sk + kMaxN * ld;
    const float* sm = reinterpret_cast<const float*>(st + 3 * L.tile);
    // the next window's tiles stream in while this one computes
    if (w + (int)gridDim.x < nWB)
      load_window<D>(smem + ((it + 1) & 1) * L.stage, L, q, k, v, mask,
                     mask_bf16, nW, s, w + gridDim.x, h, N);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // S = q kᵀ: 16 rows x 64 keys a warp
    uint32_t a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k0 = ks * 16 + 2 * gc;
      a[ks][0] = ld32(sq + r0 * ld + k0);
      a[ks][1] = ld32(sq + (r0 + 8) * ld + k0);
      a[ks][2] = ld32(sq + r0 * ld + k0 + 8);
      a[ks][3] = ld32(sq + (r0 + 8) * ld + k0 + 8);
    }
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kp = sk + (8 * j + gr) * ld + ks * 16 + 2 * gc;
        mma16816(sc[j], a[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // + bias + mask; keys past N weigh 0; row max, exp, row sum
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * gc + e;
        float x0 = -INFINITY, x1 = -INFINITY;
        if (c < N) {
          x0 = sc[j][e] + sb[ra * kBiasLd + c];
          x1 = sc[j][2 + e] + sb[rb * kBiasLd + c];
          if (mask) {
            x0 += sm[ra * N + c];
            x1 += sm[rb * N + c];
          }
        }
        sc[j][e] = x0, sc[j][2 + e] = x1;
        m0 = fmaxf(m0, x0), m1 = fmaxf(m1, x1);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - m0);
        sc[j][2 + e] = expf(sc[j][2 + e] - m1);
        l0 += sc[j][e], l1 += sc[j][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }

    // O = P v with P = hi + lo in bf16, unnormalised (e in [0, 1])
    float oc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[n][e] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // fragment f: rows r0 (f even) or r0 + 8 (f odd), key tile 2t + f/2
        const float p0 = sc[2 * t + (f >> 1)][2 * (f & 1)];
        const float p1 = sc[2 * t + (f >> 1)][2 * (f & 1) + 1];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
        hi[f] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[f] = pack(p0 - __low2float(ph), p1 - __high2float(ph));
      }
      const bf16* vrow = sv + (16 * t + (lane & 15)) * ld;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + 8 * n);
        mma16816(oc[n], hi, b0, b1);
        mma16816(oc[n], lo, b0, b1);
      }
    }

    // normalise, round once, out through the warp's own q rows
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    __syncwarp();   // every lane holds its q fragments
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(sq + r0 * ld + 8 * n + 2 * gc) =
          pack(oc[n][0] * i0, oc[n][1] * i0);
      *reinterpret_cast<uint32_t*>(sq + (r0 + 8) * ld + 8 * n + 2 * gc) =
          pack(oc[n][2] * i1, oc[n][3] * i1);
    }
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int rr = i / C, cc = 8 * (i - rr * C);
      const int r = warp * 16 + rr;
      if (r < N)
        *reinterpret_cast<uint4*>(out + (((long long)w * N + r) * H + h) * D +
                                  cc) =
            *reinterpret_cast<const uint4*>(sq + r * ld + cc);
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias,
           bool bias_bf16, const void* mask, bool mask_bf16, bf16* out,
           int nWB, int N, int H, int nW, const Strides& s,
           cudaStream_t stream) {
  // allow the largest layout once per instance; SMs counted then too
  static const int sms_or_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout(kMaxN, D, true).bytes);
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return e == cudaSuccess ? sms : -(int)e;
  }();
  if (sms_or_err < 0) return -sms_or_err;
  const int bytes = Layout(N, D, mask != nullptr).bytes;
  // blocks resident per SM at this size, kept for the last size asked (a
  // race between callers can only change the grid, never the result)
  static int last_bytes = -1, last_per_sm = 0;
  if (bytes != last_bytes) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, window_attention_bf16_kernel<D>, kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    last_bytes = bytes;
  }
  // one wave of blocks over the heads; each block walks its windows
  const int resident = last_per_sm * sms_or_err;
  int gx = resident > H ? (resident + H - 1) / H : 1;
  gx = gx < nWB ? gx : nWB;
  const dim3 grid(gx, H);
  window_attention_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, bias_bf16, mask, mask_bf16, out, nWB, N, H, nW, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (nWB, N, H, D) bf16 with unit stride over D, head stride D, and
// the window and row strides given (in elements, multiples of 8; pointers
// 16-byte aligned), so k and v may be views into a packed qkv. out
// (nWB, N, H, D) bf16 contiguous; bias (H, N, N) and mask (nW, N, N) or
// null, contiguous, each bf16 (its flag 1) or f32 (0). N <= 64, D a multiple
// of 8 up to 64. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int window_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* out, int nWB, int N, int H, int D, int nW,
    int bias_is_bf16, int mask_is_bf16, long long q_sw, long long q_sn,
    long long k_sw, long long k_sn, long long v_sw, long long v_sn,
    void* stream) {
  if (nWB < 1 || N < 1 || N > kMaxN || H < 1 || (mask && nW < 1))
    return (int)cudaErrorInvalidValue;
  const Strides s{q_sw, q_sn, k_sw, k_sn, v_sw, v_sn};
  const cudaStream_t st = (cudaStream_t)stream;
  const int period = mask ? nW : 1;
#define WA_BF16(DD)                                                        \
  case DD:                                                                 \
    return launch<DD>(static_cast<const bf16*>(q),                         \
                      static_cast<const bf16*>(k),                         \
                      static_cast<const bf16*>(v), bias, bias_is_bf16 != 0, \
                      mask, mask_is_bf16 != 0, static_cast<bf16*>(out), nWB, \
                      N, H, period, s, st)
  switch (D) {
    WA_BF16(8);
    WA_BF16(16);
    WA_BF16(24);
    WA_BF16(32);
    WA_BF16(40);
    WA_BF16(48);
    WA_BF16(56);
    WA_BF16(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WA_BF16
}
