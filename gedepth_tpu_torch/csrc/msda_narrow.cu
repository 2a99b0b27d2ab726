// Multi-scale deformable sampling at narrow heads: kernels B (forward) and
// C (backward) for heads of one or two 16-byte slices (f32 d = 4 or 8, bf16
// d = 8 or 16), in f32 and bf16. BinsFormer's deformable encoder runs them:
// 3 levels, 8 heads of 8 channels, 8 points, the exact rule.
//
// Replaces, at those widths, the Pallas TPU kernels `_kernel` of
// gedepth_tpu/ops/pallas/msda_windowed.py:112 (B; launched by
// `_pallas_level_lanes` :268, pallas_call :294, and `_pallas_level_flanes`
// :486, pallas_call :509) and `_kernel_bwd` of the same file, :898 (C;
// launched by `msda_windowed_level_bwd_offw` :967, pallas_call :1050),
// which the wide instances (csrc/msda.cu, msda_bwd.cu, msda_fwd_bf16.cu,
// msda_bwd_bf16.cu) replace at every other width. They compute what those
// compute (csrc/msda_bwd.cu has the gradients' formulas):
//   out[b, q, h·d + c] = Σ_l Σ_p w · Σ_ij cw_ij · v_ij[c]
// with zero padding outside the level; positions in level pixels.
//
// What bounds them on the H100. At BinsFormer's shapes (value (1, 6300, 8,
// 8) served, (2, 4641, 8, 8) a train crop; pos (B, Nq, 8, 3, 8, 2) f32) the
// least work is bytes: B 0.0053 ms served and 0.0078 at the train shape, C
// 0.0149 (f32; 9 and 17 f32 operations a touching sample and channel take
// less). The wide instances spent 9-14x that (PERF.md §6): they lay a
// query's d channels over a group of 4 lanes, of which d = 8 fills 2 (f32)
// or 1 (bf16), set samples up 4 at a time into shared-memory records
// behind two __syncwarp, keep the sums in shared memory between levels,
// and C ran two kernels that each set every sample up again, the d_value
// one adding two 16-byte reductions a corner (0.131 of C's 0.209 ms, f32,
// by torch.profiler).
//
// The design: a thread per (batch entry, query, head) with every channel
// in its registers, and for B's f32 instance a lane per 16-byte slice of
// it, so that a warp's corner reads fill whole 32-byte sectors. At
// BinsFormer's shapes that is 50,400 threads (B f32: 100,800 lanes) served
// and 74,256 a train crop: one wave of the card. A thread sets its own
// samples up (the set-up of csrc/msda_tile.cuh, with nothing staged),
// reads a level's positions and weights four samples at a time in 16-byte
// loads (when P is a multiple of 4 and the tensors are 16-byte aligned;
// else one by one), and walks l, then p ascending: no records, no shared
// memory, no __syncwarp, no plan. B writes its output row once. C, in one
// pass, forms the four corner dots in registers, d_w and d_pos from them
// as csrc/msda_bwd.cu does (written four samples at a time;
// deterministic), and adds w·cw·g for every corner inside the level to
// d_value in 16-byte reductions (sm_90's atomicAdd on float4, the two
// lanes of a pair filling one 32-byte sector an instruction: `CornerAdds`),
// into the f32 buffer that a bf16 launch's caller lends and that is
// rounded to bf16 once at the end.
//
// What bounds C now: those reductions, about 5.8 million corners of 32
// bytes at the train shape. Without them the kernel takes 0.065 ms of its
// 0.175 (f32; 0.052 of 0.171 in bf16); sent to addresses that share no
// neighbours they take as long, so it is the card's rate of reductions,
// not contention. What was tried (tests/msda_narrow_variants.py, device
// ms at the train shape, f32 / bf16, against 0.175 / 0.171 for this form):
// one lane adding its whole corner, 0.209 / 0.199; corners that land on
// the same (pixel, head) within a warp summed before one add
// (`__match_any_sync` on the address; at most 6% of this data's corner
// adds share a warp), 0.224 / 0.218, and with a warp of 32 queries of one
// head, 0.229 / 0.223; the adds as TMA bulk reductions of 32 bytes from
// shared memory (`cp.reduce.async.bulk`), 0.173 / 0.177; blocks of 256 to
// 1,024 threads, 0.196-0.217 / 0.182-0.215. B f32 with one thread reading
// both slices took 0.052 ms at the train shape against 0.037; sharing the
// set-up of a lane pair's samples by shuffles was slower still.
//
// The arithmetic is the wide instances': B in f32 is `blend_add` of
// csrc/msda.cu (c01·v01 rounded, then fma of c00, c10, c11, then fma of the
// weight into the sum) and in bf16 that of csrc/msda_fwd_bf16.cu (the
// weight folded into the coefficients, four fmas, one rounding), per
// channel over l, p ascending, so each equals its wide instance bit for
// bit. C's dots are summed over the channels in order (the wide instances
// summed lanes' partial dots by shuffles), so its d_pos and d_w agree with
// them to rounding; d_value's adds meet in any order, as theirs do.
#include "msda_tile.cuh"

namespace {

using namespace msda_tile;

// threads of a block: B's f32 instance reads faster in blocks of 256, its
// bf16 instance and C in blocks of 128 (tests/msda_narrow_variants.py)
constexpr int kNarrowThreads = 128;
template <typename T>
__host__ __device__ constexpr int forward_threads() {
  return sizeof(T) == 4 ? 256 : 128;
}

// The D channels of a head at p, lifted to f32: 16-byte loads through the
// read-only path.
template <int D>
__device__ __forceinline__ void load_head(float (&dst)[D], const float* p) {
#pragma unroll
  for (int k = 0; k < D / 4; ++k) {
    float t[4];
    load_vec<4, true>(t, p + 4 * k);
#pragma unroll
    for (int v = 0; v < 4; ++v) dst[4 * k + v] = t[v];
  }
}

template <int D>
__device__ __forceinline__ void load_head(float (&dst)[D], const bf16* p) {
#pragma unroll
  for (int k = 0; k < D / 8; ++k) {
    float t[8];
    load_slice<8, true>(t, p + 8 * k);
#pragma unroll
    for (int v = 0; v < 8; ++v) dst[8 * k + v] = t[v];
  }
}

template <int D>
__device__ __forceinline__ void store_head(float* p, const float (&src)[D]) {
#pragma unroll
  for (int k = 0; k < D / 4; ++k) {
    const float t[4] = {src[4 * k], src[4 * k + 1], src[4 * k + 2],
                        src[4 * k + 3]};
    store_vec<4>(p + 4 * k, t);
  }
}

template <int D>
__device__ __forceinline__ void store_head(bf16* p, const float (&src)[D]) {
#pragma unroll
  for (int k = 0; k < D / 8; ++k) {
    float t[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) t[v] = src[8 * k + v];
    store_slice<8>(p + 8 * k, t);
  }
}

// Four samples from k0 of a (query, head, level) row of P: positions and
// weights, 16-byte loads when kVec (P a multiple of 4, both tensors 16-byte
// aligned); a sample past P gets weight 0 and is skipped by the caller.
template <bool kVec>
__device__ __forceinline__ void load_four(const float* pp, const float* wp,
                                          int k0, int P, float (&x)[4],
                                          float (&y)[4], float (&a)[4]) {
  if constexpr (kVec) {
    const float4 p0 = __ldg(reinterpret_cast<const float4*>(pp + 2 * k0));
    const float4 p1 = __ldg(reinterpret_cast<const float4*>(pp + 2 * k0) + 1);
    const float4 w = __ldg(reinterpret_cast<const float4*>(wp + k0));
    x[0] = p0.x, y[0] = p0.y, x[1] = p0.z, y[1] = p0.w;
    x[2] = p1.x, y[2] = p1.y, x[3] = p1.z, y[3] = p1.w;
    a[0] = w.x, a[1] = w.y, a[2] = w.z, a[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = y[j] = a[j] = 0.f;
      if (k0 + j < P) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(pp) + k0 + j);
        x[j] = xy.x, y[j] = xy.y;
        a[j] = __ldg(wp + k0 + j);
      }
    }
  }
}

// The four corners of a sample set up with nothing staged: element offsets
// from the level's (head) origin.
struct CornerOffsets {
  int off[4];
  __device__ __forceinline__ explicit CornerOffsets(const Record& r) {
    const int sy = -1 - r.sy;
    off[0] = r.off, off[1] = r.off + r.sx;
    off[2] = r.off + sy, off[3] = r.off + r.sx + sy;
  }
};

// out row += the sample's bilinear value: csrc/msda.cu `blend_add` (f32) or
// csrc/msda_fwd_bf16.cu's folded blend (bf16), channel by channel
template <int D>
__device__ __forceinline__ void blend(float (&acc)[D], const float* vl,
                                      const Record& r) {
  const CornerOffsets at(r);
  float v00[D], v01[D], v10[D], v11[D];
  load_head(v00, vl + at.off[0]);
  load_head(v01, vl + at.off[1]);
  load_head(v10, vl + at.off[2]);
  load_head(v11, vl + at.off[3]);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float s = r.c01 * v01[c];
    s = fmaf(r.c00, v00[c], s);
    s = fmaf(r.c10, v10[c], s);
    s = fmaf(r.c11, v11[c], s);
    acc[c] = fmaf(r.a, s, acc[c]);
  }
}

template <int D>
__device__ __forceinline__ void blend(float (&acc)[D], const bf16* vl,
                                      const Record& r) {
  const CornerOffsets at(r);
  const float a = r.a;
  const float c00 = r.c00 * a, c01 = r.c01 * a, c10 = r.c10 * a,
              c11 = r.c11 * a;
  float v00[D], v01[D], v10[D], v11[D];
  load_head(v00, vl + at.off[0]);
  load_head(v01, vl + at.off[1]);
  load_head(v10, vl + at.off[2]);
  load_head(v11, vl + at.off[3]);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float t = fmaf(c00, v00[c], acc[c]);
    t = fmaf(c01, v01[c], t);
    t = fmaf(c10, v10[c], t);
    acc[c] = fmaf(c11, v11[c], t);
  }
}

// channels of a 16-byte slice
template <typename T>
__host__ __device__ constexpr int slice_elems() {
  return 16 / (int)sizeof(T);
}

// Kernel B: value (B, S, h, D), out (B, Nq, h·D). A lane a 16-byte slice
// of a (b, q, h): the slices of a head on neighbouring lanes, so that a
// warp's corner reads fill whole 32-byte sectors; each lane sets the
// samples up itself.
template <typename T, int D, bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads)
msda_narrow_fwd_kernel(const T* __restrict__ value,
                       const int* __restrict__ levels,
                       const float* __restrict__ pos,
                       const float* __restrict__ weight,
                       T* __restrict__ out, long long n_qh, int S, int Nq,
                       int h, int L, int P) {
  constexpr int E = slice_elems<T>(), kSlices = D / E;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long qh = t / kSlices;
  if (qh >= n_qh) return;
  const int c0 = (int)(t % kSlices) * E;  // the lane's first channel
  const long long b = qh / ((long long)Nq * h);
  const int head = (int)(qh % h);
  const int hd = h * D;
  constexpr Rect kUnstaged{0, 0, 0, 0};  // nothing staged
  float acc[E];
#pragma unroll
  for (int c = 0; c < E; ++c) acc[c] = 0.f;
  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const T* vl = value + (b * S + levels[3 * l + 2]) * hd + head * D + c0;
    const long long row = (qh * L + l) * P;
    const float* pp = pos + row * 2;
    const float* wp = weight + row;
    for (int k0 = 0; k0 < P; k0 += 4) {
      float x[4], y[4], a[4];
      load_four<kVec>(pp, wp, k0, P, x, y, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!kVec && k0 + j >= P) break;
        const Record r =
            setup_sample(x[j], y[j], a[j], Hl, Wl, kUnstaged, D, hd).rec;
        blend<E>(acc, vl, r);
      }
    }
  }
  store_head<E>(out + qh * D + c0, acc);
}

// w·cw·g of a corner added to d_value's f32 sums, 16 bytes a reduction.
// Where a corner's sums are whole 32-byte sectors (D a multiple of 8), the
// two lanes of a pair add the two halves of each sector of one corner in
// one instruction, the even lane's corner first, then the odd lane's (one
// lane adding its whole corner, two reductions into one sector, took 0.209
// ms at BinsFormer's train shape against 0.175 for the pairs; the wide
// instance's lanes pair so too). Every lane of the warp calls `add` for
// every corner, with weight 0 for none.
template <int D, bool kPairs = D % 8 == 0>
struct CornerAdds {
  // the g row (kPairs: the lane's half of each sector of it), and its
  // partner's half
  float own[kPairs ? D / 2 : D], other[kPairs ? D / 2 : 1];
  int half;

  __device__ __forceinline__ explicit CornerAdds(const float (&g)[D]) {
    half = threadIdx.x & 1;
    if constexpr (kPairs) {
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float lo = g[8 * k + v], hi = g[8 * k + 4 + v];
          own[4 * k + v] = half ? hi : lo;
          other[4 * k + v] = __shfl_xor_sync(kFullMask, half ? lo : hi, 1);
        }
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) own[c] = g[c];
    }
  }

  __device__ __forceinline__ void add(float* p, float wc) const {
    if constexpr (kPairs) {
      const unsigned long long mine = reinterpret_cast<unsigned long long>(p);
      const unsigned long long theirs = __shfl_xor_sync(kFullMask, mine, 1);
      const float their_wc = __shfl_xor_sync(kFullMask, wc, 1);
#pragma unroll
      for (int turn = 0; turn < 2; ++turn) {
        const bool own_turn = turn == half;
        const float c = own_turn ? wc : their_wc;
        if (c == 0.f) continue;  // no corner, or one outside the level
        float* q = reinterpret_cast<float*>(own_turn ? mine : theirs) +
                   4 * half;
#pragma unroll
        for (int k = 0; k < D / 8; ++k) {
          float t[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            t[v] = c * (own_turn ? own[4 * k + v] : other[4 * k + v]);
          atomicAdd(reinterpret_cast<float4*>(q + 8 * k),
                    make_float4(t[0], t[1], t[2], t[3]));
        }
      }
    } else if (wc != 0.f) {
#pragma unroll
      for (int k = 0; k < D / 4; ++k)
        atomicAdd(reinterpret_cast<float4*>(p + 4 * k),
                  make_float4(wc * own[4 * k], wc * own[4 * k + 1],
                              wc * own[4 * k + 2], wc * own[4 * k + 3]));
    }
  }
};

// Kernel C, one pass: value (B, S, h, D) and grad_out (B, Nq, h·D) of T;
// d_value (f32 sums of the value's shape, zeroed by the entry), d_pos and
// d_weight f32 in the shapes of pos and weight. One thread a (b, q, h); a
// thread past the last runs on the last one's rows with weight 0 and
// writes nothing, so that its pair stays whole.
template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kNarrowThreads)
msda_narrow_bwd_kernel(const T* __restrict__ value,
                       const int* __restrict__ levels,
                       const float* __restrict__ pos,
                       const float* __restrict__ weight,
                       const T* __restrict__ grad_out,
                       float* __restrict__ d_value,
                       float* __restrict__ d_pos,
                       float* __restrict__ d_weight, long long n_qh, int S,
                       int Nq, int h, int L, int P) {
  const long long t = (long long)blockIdx.x * kNarrowThreads + threadIdx.x;
  const bool active = t < n_qh;
  const long long qh = active ? t : n_qh - 1;
  const long long b = qh / ((long long)Nq * h);
  const int head = (int)(qh % h);
  const int hd = h * D;
  constexpr Rect kUnstaged{0, 0, 0, 0};  // nothing staged
  float g[D];
  load_head(g, grad_out + qh * D);
  const CornerAdds<D> adds(g);
  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const long long level_at = (b * S + levels[3 * l + 2]) * hd + head * D;
    const T* vl = value + level_at;
    float* dvl = d_value + level_at;
    const long long row = (qh * L + l) * P;
    const float* pp = pos + row * 2;
    const float* wp = weight + row;
    for (int k0 = 0; k0 < P; k0 += 4) {
      float x[4], y[4], a[4];
      load_four<kVec>(pp, wp, k0, P, x, y, a);
      float dw[4], dx[4], dy[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dw[j] = dx[j] = dy[j] = 0.f;
        if (!kVec && k0 + j >= P) break;
        const Setup su =
            setup_sample(x[j], y[j], a[j], Hl, Wl, kUnstaged, D, hd);
        const Record& r = su.rec;
        const CornerOffsets at(r);
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[D];
          load_head(v, vl + at.off[i]);
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) dot = fmaf(g[c], v[c], dot);
          s[i] = dot;
        }
        // a corner outside the level was read at a clamped address: its
        // dot counts as zero
        const float s00 = su.in00 ? s[0] : 0.f, s01 = su.in01 ? s[1] : 0.f;
        const float s10 = su.in10 ? s[2] : 0.f, s11 = su.in11 ? s[3] : 0.f;
        dw[j] = r.c00 * s00 + r.c01 * s01 + r.c10 * s10 + r.c11 * s11;
        dx[j] = a[j] * ((1.f - su.fy) * (s01 - s00) + su.fy * (s11 - s10));
        dy[j] = a[j] * ((1.f - su.fx) * (s10 - s00) + su.fx * (s11 - s01));
        const float cw[4] = {r.c00, r.c01, r.c10, r.c11};
#pragma unroll
        for (int i = 0; i < 4; ++i)  // cw 0: outside the level
          adds.add(dvl + at.off[i], active ? a[j] * cw[i] : 0.f);
      }
      if (!active) continue;
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(d_weight + row + k0) =
            make_float4(dw[0], dw[1], dw[2], dw[3]);
        float4* dp = reinterpret_cast<float4*>(d_pos + (row + k0) * 2);
        dp[0] = make_float4(dx[0], dy[0], dx[1], dy[1]);
        dp[1] = make_float4(dx[2], dy[2], dx[3], dy[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + j >= P) break;
          d_weight[row + k0 + j] = dw[j];
          reinterpret_cast<float2*>(d_pos + row * 2)[k0 + j] =
              make_float2(dx[j], dy[j]);
        }
      }
    }
  }
}

// d_value of a bf16 launch: the f32 sums rounded to nearest even, once
__global__ void round_narrow_kernel(const float* __restrict__ src,
                                    bf16* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

unsigned grid_of(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

template <typename T, int D>
int forward(const T* value, const int* levels, const float* pos,
            const float* weight, T* out, int B, int S, int Nq, int h, int L,
            int P, int vec, cudaStream_t stream) {
  const long long n_qh = (long long)B * Nq * h;
  if (n_qh == 0) return (int)cudaGetLastError();
  constexpr int block = forward_threads<T>();
  const unsigned grid = grid_of(n_qh * (D / slice_elems<T>()), block);
  if (vec) {
    msda_narrow_fwd_kernel<T, D, true, block><<<grid, block, 0, stream>>>(
        value, levels, pos, weight, out, n_qh, S, Nq, h, L, P);
  } else {
    msda_narrow_fwd_kernel<T, D, false, block><<<grid, block, 0, stream>>>(
        value, levels, pos, weight, out, n_qh, S, Nq, h, L, P);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int backward(const T* value, const int* levels, const float* pos,
             const float* weight, const T* grad_out, float* d_value_acc,
             float* d_pos, float* d_weight, int B, int S, int Nq, int h,
             int L, int P, int vec, cudaStream_t stream) {
  const long long n_qh = (long long)B * Nq * h;
  if (n_qh == 0) return (int)cudaGetLastError();
  if (vec) {
    msda_narrow_bwd_kernel<T, D, true>
        <<<grid_of(n_qh, kNarrowThreads), kNarrowThreads, 0, stream>>>(
            value, levels, pos, weight, grad_out, d_value_acc, d_pos,
            d_weight, n_qh, S, Nq, h, L, P);
  } else {
    msda_narrow_bwd_kernel<T, D, false>
        <<<grid_of(n_qh, kNarrowThreads), kNarrowThreads, 0, stream>>>(
            value, levels, pos, weight, grad_out, d_value_acc, d_pos,
            d_weight, n_qh, S, Nq, h, L, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B at a narrow head. value (B, S, h, d) and out (B, Nq, h·d) f32,
// both 16-byte aligned, d = 4 or 8; levels (L, 3) int32 rows (H, W,
// start); pos (B, Nq, h, L, P, 2) f32, 8-byte aligned; weight (B, Nq, h, L,
// P) f32; all contiguous, a level below 2^31 elements. vec = 1: P a
// multiple of 4 and pos, weight 16-byte aligned (positions and weights
// read 16 bytes at a time). Returns the CUDA error of the launch, or
// cudaErrorInvalidValue for another head width.
extern "C" int msda_narrow_fwd(const float* value, const int* levels,
                               const float* pos, const float* weight,
                               float* out, int B, int S, int Nq, int h,
                               int d, int L, int P, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 4)
    return forward<float, 4>(value, levels, pos, weight, out, B, S, Nq, h, L,
                             P, vec, st);
  if (d == 8)
    return forward<float, 8>(value, levels, pos, weight, out, B, S, Nq, h, L,
                             P, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The same for a bf16 value and out, d = 8 or 16.
extern "C" int msda_narrow_fwd_bf16(const bf16* value, const int* levels,
                                    const float* pos, const float* weight,
                                    bf16* out, int B, int S, int Nq, int h,
                                    int d, int L, int P, int vec,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 8)
    return forward<bf16, 8>(value, levels, pos, weight, out, B, S, Nq, h, L,
                            P, vec, st);
  if (d == 16)
    return forward<bf16, 16>(value, levels, pos, weight, out, B, S, Nq, h,
                             L, P, vec, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel C at a narrow head. value and grad_out f32 as `msda_narrow_fwd`
// takes value and out; d_value_acc is d_value itself (f32, 16-byte
// aligned), zeroed here and summed into; d_pos and d_weight f32 in the
// shapes of pos and weight (16-byte aligned when vec = 1). Launches on
// `stream` the memset and the kernel; returns the CUDA error.
extern "C" int msda_narrow_bwd(const float* value, const int* levels,
                               const float* pos, const float* weight,
                               const float* grad_out, float* d_value_acc,
                               float* d_value, float* d_pos, float* d_weight,
                               int B, int S, int Nq, int h, int d, int L,
                               int P, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      d_value_acc, 0, (size_t)B * S * h * d * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (d == 4)
    return backward<float, 4>(value, levels, pos, weight, grad_out,
                              d_value_acc, d_pos, d_weight, B, S, Nq, h, L,
                              P, vec, st);
  if (d == 8)
    return backward<float, 8>(value, levels, pos, weight, grad_out,
                              d_value_acc, d_pos, d_weight, B, S, Nq, h, L,
                              P, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The same for a bf16 value, grad_out and d_value, d = 8 or 16: the sums
// go to d_value_acc, an f32 buffer of the value's shape that the caller
// lends (16-byte aligned), zeroed here and rounded into d_value once at
// the end.
extern "C" int msda_narrow_bwd_bf16(const bf16* value, const int* levels,
                                    const float* pos, const float* weight,
                                    const bf16* grad_out, float* d_value_acc,
                                    bf16* d_value, float* d_pos,
                                    float* d_weight, int B, int S, int Nq,
                                    int h, int d, int L, int P, int vec,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * S * h * d;
  cudaError_t err =
      cudaMemsetAsync(d_value_acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  int e;
  if (d == 8) {
    e = backward<bf16, 8>(value, levels, pos, weight, grad_out, d_value_acc,
                          d_pos, d_weight, B, S, Nq, h, L, P, vec, st);
  } else if (d == 16) {
    e = backward<bf16, 16>(value, levels, pos, weight, grad_out, d_value_acc,
                           d_pos, d_weight, B, S, Nq, h, L, P, vec, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  round_narrow_kernel<<<1024, 256, 0, st>>>(d_value_acc, d_value, n);
  return (int)cudaGetLastError();
}
