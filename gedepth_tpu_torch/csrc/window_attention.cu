// Swin window attention, forward, f32, register-tiled with a cp.async ring.
//
// Replaces the Pallas TPU kernel `_forward_pallas` of
// gedepth_tpu/ops/pallas/window_attn.py:49 (pallas_call at :80 unmasked and
// :108 masked), which the JAX model reaches as `window_attention_xla`
// (gedepth_tpu/ops/window_attention.py:34): for each window w and head h,
//   out[w, :, h, :] = softmax(q kᵀ + bias[h] + mask[w mod nW]) v
// with q pre-scaled and rows of the softmax over the N = window² keys.
//
// Shapes on the model's path (Swin-L, N = 49, D = 32): serving 352x1216
// has 572/154/44/12 windows at 6/12/24/48 heads; the train crop 352x704 at
// batch 2 has 676 windows at stage 1 with a (338, 49, 49) mask.
//
// Floors on the H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores, 700 W):
// per (window, head) the kernel reads q, k, v and writes out, 4·N·D floats
// (25 KB), and does 4·N²·D FLOP (0.31 M). Stage 1 (572,49,6,32): 86 MB,
// ~26 µs of bytes, 1.06 GFLOP, ~16 µs of FMA; the shift mask adds 5.5 MB,
// read once from device memory and then from L2.
//
// Design:
//   - register tiles: a block of 4 warps owns one head and walks windows
//     bx, bx + gridDim.x, ...; each warp owns 16 of the 64 query rows a
//     window pads to. A lane holds a 4 x 8 tile of logits (rows r0 + 4i,
//     keys cg + 8j; 4 x 7 when N <= 56, so no lane works on keys that are
//     all padding), fed by 16-byte loads of q and k rows (11 loads for 112
//     FMA at N = 49); row max and row sum go through shuffles among the 8
//     lanes of a row. Only the probabilities go through a per-warp shared
//     slice for P·v, where a lane holds 4 rows x D/8 channels;
//   - a two-stage cp.async ring of q, k, v tiles (16-byte copies that
//     bypass L1) and the window's mask row: the next window's tiles arrive
//     while this one computes. Reading the mask from L2 in the softmax
//     instead cost 2x at stage 1 shifted (180 vs 91 µs);
//   - bias[h] staged in shared memory once per block;
//   - rows and keys past N read row N - 1 (finite, never stored; the keys
//     get -inf), so no tile holds pad rows but v's last few, kept at 0;
//   - strided q, k, v: the kernel takes each tensor's window and row
//     stride, so k and v are read straight out of the packed qkv;
//   - row strides of shared tiles chosen so that the loads of a warp phase
//     fall in distinct banks (D + 4 for q, k, v; 56 or 72 for bias and P).
// Every rounding follows the plain version's: q·k over d and P·v over keys
// in index order by fmaf, + bias then + mask, exp by expf, the row sum in
// the order of PyTorch's warp softmax and p = e / sum rounded to nearest.
// For 33 <= N <= 64 (Swin's N = 49) the result equals the plain version's
// bit for bit (measured at every Swin-L shape). That matters: a train
// step's decode-head conv gradients move ~4.5e-4 relative per 1e-7
// relative change in this op's output. No atomics.
// Measured (H100 80GB HBM3, 700 W, 50 back-to-back launches): stage 1
// 76.5 µs, stage 1 shifted 90.0 µs, stage 3 shifted 29.8 µs, against 228,
// 264 and 131 µs for the plain version: ~3x the byte floor. What bounds
// it is the arithmetic, not device memory: with the loads of later windows
// cut out (every window reuses the first one's tiles) it still takes
// 75.5 µs at stage 1, while the cp.async ring and the stores alone take
// 37.9 µs, a plain copy of the same bytes 34.8 µs. The padded tiles cost
// ~1.4x the FMA of N = 49, each fed by shared-memory loads, and with
// 70 KB (90 KB with the mask) of shared memory 3 (2) blocks of 4 warps
// share an SM to hide their latency. The next step is split-precision
// 3xTF32 `mma.sync`, which needs ~10x fewer instructions for the two
// products, but rounds otherwise than the plain version. Head width D is a
// template parameter (multiples of 8 up to 64).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 64;   // 4 warps x 16 query rows, 8 x 8 key columns

// Shared-memory layout in floats, for N tokens and head width D: a ring of
// two stages, each q, k, v (R rows of D + 4, R = N rounded up to 4) and the
// window's mask row (N², rounded up to 4); then bias[h] (N rows) and each
// warp's 16 rows of P, both at row stride ldp (56 or 72: ≡ 24 or 8 mod 32,
// so the 4 row groups x 8 columns of a warp access fall in distinct
// banks).
struct Layout {
  int R, ldp, stage, floats;
  __host__ __device__ Layout(int N, int D, bool masked) {
    R = (N + 3) & ~3;
    ldp = R <= 56 ? 56 : 72;
    stage = 3 * R * (D + 4) + (masked ? (N * N + 3) & ~3 : 0);
    floats = 2 * stage + N * ldp + kWarps * 16 * ldp;
  }
};

struct Strides {
  long long qw, qn, kw, kn, vw, vn;   // window and row strides, in floats
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
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

// rows 0..N-1 of window w, head h (and its mask row) into one ring stage;
// the pad rows of v stay 0
template <int D>
__device__ __forceinline__ void load_window(float* st, int R, const float* q,
                                            const float* k, const float* v,
                                            const float* mask, int nW,
                                            const Strides& s, int w, int h,
                                            int N) {
  constexpr int C = D / 4;   // 16-byte chunks per row
  constexpr int ld = D + 4;
  const float* gq = q + w * s.qw + h * D;
  const float* gk = k + w * s.kw + h * D;
  const float* gv = v + w * s.vw + h * D;
  float* sq = st;
  float* sk = sq + R * ld;
  float* sv = sk + R * ld;
  for (int i = threadIdx.x; i < N * C; i += kThreads) {
    const int n = i / C, c = 4 * (i - n * C);
    cp_async16(sq + n * ld + c, gq + n * s.qn + c);
    cp_async16(sk + n * ld + c, gk + n * s.kn + c);
    cp_async16(sv + n * ld + c, gv + n * s.vn + c);
  }
  if (mask) {
    const float* gm = mask + (long long)(w % nW) * N * N;
    float* sm = sv + R * ld;
    for (int i = threadIdx.x; i < N * N; i += kThreads)
      cp_async4(sm + i, gm + i);
  }
}

template <int DL>
__device__ __forceinline__ void load_row(float (&dst)[DL], const float* p) {
  if constexpr (DL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DL; t += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + t);
      dst[t] = x.x; dst[t + 1] = x.y; dst[t + 2] = x.z; dst[t + 3] = x.w;
    }
  } else if constexpr (DL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DL; t += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + t);
      dst[t] = x.x; dst[t + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < DL; ++t) dst[t] = p[t];
  }
}

template <int DL>
__device__ __forceinline__ void store_row(float* p, const float (&o)[DL]) {
  if constexpr (DL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DL; t += 4)
      *reinterpret_cast<float4*>(p + t) =
          make_float4(o[t], o[t + 1], o[t + 2], o[t + 3]);
  } else if constexpr (DL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DL; t += 2)
      *reinterpret_cast<float2*>(p + t) = make_float2(o[t], o[t + 1]);
  } else {
#pragma unroll
    for (int t = 0; t < DL; ++t) p[t] = o[t];
  }
}

// KG key groups of 8 per lane: 7 when N <= 56, so that no lane computes
// logits of keys that are all padding
template <int D, int KG>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int nWB, int N, int H,
                        int nW, Strides s) {
  constexpr int ld = D + 4;
  constexpr int DL = D / 8;   // output channels of a lane in P·v
  const Layout L(N, D, mask != nullptr);
  const int R = L.R, ldp = L.ldp;
  extern __shared__ __align__(16) float smem[];
  float* sb = smem + 2 * L.stage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sp = sb + N * ldp + warp * 16 * ldp;
  const int h = blockIdx.y;
  const int rg = lane >> 3, cg = lane & 7;
  const int r0 = warp * 16 + rg;   // this lane's rows: r0 + 4i
  // rows and keys past N read row N - 1: finite, never stored, masked out
  int rq[4], ck[KG];
#pragma unroll
  for (int i = 0; i < 4; ++i) rq[i] = min(r0 + 4 * i, N - 1);
#pragma unroll
  for (int j = 0; j < KG; ++j) ck[j] = min(cg + 8 * j, N - 1);
  const int nc = R;   // P·v runs over R keys: P and v are 0 past N

  for (int i = threadIdx.x; i < 2 * L.stage; i += kThreads) smem[i] = 0.f;
  const float* bh = bias + (long long)h * N * N;
  for (int i = threadIdx.x; i < N * N; i += kThreads) {
    const int r = i / N;
    sb[r * ldp + i - r * N] = bh[i];
  }
  __syncthreads();   // zeros written before cp.async fills the rows

  int w = blockIdx.x;
  load_window<D>(smem, R, q, k, v, mask, nW, s, w, h, N);
  cp_async_commit();
  for (int it = 0; w < nWB; ++it, w += gridDim.x) {
    const float* sq = smem + (it & 1) * L.stage;
    const float* sk = sq + R * ld;
    const float* sv = sk + R * ld;
    const float* sm = sv + R * ld;   // the mask row w mod nW
    // the next window's tiles stream in while this one computes
    if (w + (int)gridDim.x < nWB)
      load_window<D>(smem + ((it + 1) & 1) * L.stage, R, q, k, v, mask, nW,
                     s, w + gridDim.x, h, N);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // logits: 4 rows x KG keys per lane
    float acc[4][KG];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KG; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[KG];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + rq[i] * ld + d);
#pragma unroll
      for (int j = 0; j < KG; ++j)
        b[j] = *reinterpret_cast<const float4*>(sk + ck[j] * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KG; ++j) {
          float x = acc[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          x = fmaf(a[i].w, b[j].w, x);
          acc[i][j] = x;
        }
    }

    // + bias + mask, row softmax into the warp's P slice
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int c = cg + 8 * j;
        float x = -INFINITY;
        if (c < N) {
          x = acc[i][j] + sb[rq[i] * ldp + c];
          if (mask) x += sm[rq[i] * N + c];
        }
        acc[i][j] = x;
        m = fmaxf(m, x);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float e[8] = {};   // keys past the KG groups weigh 0
#pragma unroll
      for (int j = 0; j < KG; ++j) e[j] = expf(acc[i][j] - m);
      // the row sum in the order of PyTorch's warp softmax for 33..64 keys:
      // key t plus key t + 32 on lane t, then xor shuffles 16, 8, 4, 2, 1;
      // with t = cg + 8j those are j ^ 4, j ^ 2, j ^ 1 in this lane, then
      // lanes cg ^ 4, ^ 2, ^ 1
      float l = ((e[0] + e[4]) + (e[2] + e[6])) +
                ((e[1] + e[5]) + (e[3] + e[7]));
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
      // p = e / l rounded to nearest, as PyTorch divides, from the rounded
      // reciprocal and one FMA correction (Markstein): exact while p is a
      // normal float, without division's slow path for the tiny e of
      // masked keys
      const float r = __frcp_rn(l);
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int c = cg + 8 * j;
        if (c < nc) {
          const float p = __fmul_rn(e[j], r);
          sp[(rg + 4 * i) * ldp + c] = fmaf(fmaf(-p, l, e[j]), r, p);
        }
      }
    }
    __syncwarp();

    // P·v: 4 rows x DL channels per lane, keys in index order
    const int d0 = cg * DL;
    float o[4][DL];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < DL; ++t) o[i][t] = 0.f;
    for (int c = 0; c < nc; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(sp + (rg + 4 * i) * ldp + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DL];
        load_row<DL>(vv, sv + (c + u) * ld + d0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int t = 0; t < DL; ++t) o[i][t] = fmaf(pu, vv[t], o[i][t]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      if (r < N)
        store_row<DL>(out + (((long long)w * N + r) * H + h) * D + d0, o[i]);
    }
    __syncthreads();   // every warp is done with this stage before reuse
  }
}

template <int D, int KG>
int launch_groups(const float* q, const float* k, const float* v,
                  const float* bias, const float* mask, float* out, int nWB,
                  int N, int H, int nW, const Strides& s,
                  cudaStream_t stream) {
  // allow the largest layout once per instance; SMs counted then too
  static const int sms_or_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        window_attention_kernel<D, KG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(Layout(kMaxN, D, true).floats * sizeof(float)));
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return e == cudaSuccess ? sms : -(int)e;
  }();
  if (sms_or_err < 0) return -sms_or_err;
  const int bytes =
      (int)(Layout(N, D, mask != nullptr).floats * sizeof(float));
  // blocks resident per SM at this size, kept for the last size asked (a
  // race between callers can only change the grid, never the result)
  static int last_bytes = -1, last_per_sm = 0;
  if (bytes != last_bytes) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, window_attention_kernel<D, KG>, kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    last_bytes = bytes;
  }
  // one wave of blocks over the heads; each block walks its windows
  const int resident = last_per_sm * sms_or_err;
  int gx = resident > H ? (resident + H - 1) / H : 1;
  gx = gx < nWB ? gx : nWB;
  const dim3 grid(gx, H);
  window_attention_kernel<D, KG><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, mask, out, nWB, N, H, nW, s);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* mask, float* out, int nWB, int N, int H, int nW,
           const Strides& s, cudaStream_t stream) {
  return N <= 56 ? launch_groups<D, 7>(q, k, v, bias, mask, out, nWB, N, H,
                                       nW, s, stream)
                 : launch_groups<D, 8>(q, k, v, bias, mask, out, nWB, N, H,
                                       nW, s, stream);
}

}  // namespace

// q, k, v: (nWB, N, H, D) f32 with unit stride over D, head stride D, and
// the window and row strides given (in floats, multiples of 4; pointers
// 16-byte aligned), so k and v may be views into a packed qkv. out
// (nWB, N, H, D) contiguous; bias (H, N, N) and mask (nW, N, N) or null,
// contiguous. N <= 64, D a multiple of 8 up to 64. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int window_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* mask, float* out, int nWB,
                                    int N, int H, int D, int nW,
                                    long long q_sw, long long q_sn,
                                    long long k_sw, long long k_sn,
                                    long long v_sw, long long v_sn,
                                    void* stream) {
  if (nWB < 1 || N < 1 || N > kMaxN || H < 1 || (mask && nW < 1))
    return (int)cudaErrorInvalidValue;
  const Strides s{q_sw, q_sn, k_sw, k_sn, v_sw, v_sn};
  const cudaStream_t st = (cudaStream_t)stream;
  const int period = mask ? nW : 1;
  switch (D) {
    case 8:  return launch<8>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 16: return launch<16>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 24: return launch<24>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 32: return launch<32>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 40: return launch<40>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 48: return launch<48>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 56: return launch<56>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    case 64: return launch<64>(q, k, v, bias, mask, out, nWB, N, H, period, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
