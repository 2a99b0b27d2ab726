// Multi-level deformable sampling, forward (kernel B), for a bf16 value: the
// output in bf16, positions, attention weights and every sum in f32.
//
// Replaces, for a bf16 value, the Pallas TPU kernel `_kernel` of
// gedepth_tpu/ops/pallas/msda_windowed.py:112, launched by
// `_pallas_level_lanes` (:268, pallas_call :294) and `_pallas_level_flanes`
// (:486, pallas_call :509); its level loop also covers what `_kernel_multi`
// (:627) fused. It computes what the f32 instance (csrc/msda.cu) computes:
//   out[b, q, h·d + c] = Σ_l Σ_p w[b,q,h,l,p] ·
//                        bilinear(value_l[b, :, :, h, c], pos[b,q,h,l,p])
// with zero padding outside the level, the sums in f32, rounded to bf16 to
// nearest even once at the store. Deterministic: no atomics; per channel
// the samples are summed over l, p ascending, so any plan gives the same
// bits.
//
// What bounds it on the H100. At the serving cross-attention (value (1,
// 35530, 8, 64) bf16, 107,008 queries, 8 heads, 4 levels, 8 points) the
// work is 9 f32 operations a touching sample and channel on the CUDA cores,
// 0.22 ms at 67 TFLOP/s, against 0.03 ms for its bytes: operations bound
// it. The f32 source compiled for bf16 took 1.48 ms there against the f32
// instance's 1.62 (PERF.md): it read bf16 in 8-byte slices over the f32
// lane groups (16 lanes a query at d = 64), so every sample cost twice the
// lanes, twice the record reads and half-width loads for the same FMAs, and
// the tile's f32 running sums took 32 KB of a block's shared memory.
//
// The design:
//   * 16-byte slices of 8 bf16: a query's d channels lie over G = d / 8
//     lanes (8 at d = 64, at least 4), so a warp holds 4 queries and every
//     corner read is one 16-byte load a lane (`load_slice`, lifted to f32
//     by shift and mask).
//   * the tile's running sums in registers: 512 threads are 64 groups of 8
//     lanes, a tile of 128 queries 2 queries a group, 16 f32 sums a lane
//     kept across the level loop. The group's queries take turns at the
//     front of the sums (`rotate`), so the query loop is not unrolled (an
//     unrolled one outgrew the instruction cache in the f32 instance).
//   * each sample is set up once a lane group, as in the f32 instance: lane
//     j sets up sample j (floor, bounds, corner coefficients, offset) and
//     leaves a 32-byte record that the group reads back; the attention
//     weight is folded into the four corner coefficients there, so a
//     channel costs 4 FMAs, not 5 (the f32 instance keeps its own order,
//     on which a train step's gradients depend: csrc/msda.cu `blend_add`).
//   * no staged window: every corner is read through L1. A block takes its
//     128 queries in the order of its plan (a rectangle of the query grid
//     with a window hint, the card's plan of csrc/msda_plan.cu without one),
//     so neighbouring lane groups read neighbouring pixels; at HAHI's shapes
//     the bf16 value (36-42 MB) fits the 50 MB L2, and with shared memory
//     holding only the records, L1 keeps the rest of the SM's 256 KB. A
//     window staged in shared memory (cp.async), which the f32 instance
//     needs, read slower at every windowed, compat and exact shape tried:
//     its copies and barriers cost more than its reads saved, and it took
//     L1's room. The staged reading stays as an instance of its own
//     (kStage), which a launch takes when its plan stages a window: that
//     is how tests/msda_plan_rules.py --budget measures the choice again;
//     the production launches give it no budget.
//
// Tried on the H100: the sample loop unrolled 4 times reads a little faster
// than once or twice (kept); the group's two queries unrolled in place of
// the turns ran no faster; one block of 512 threads an SM with more
// registers, or three with 42 (which spill), ran slower: the kernel wants
// its 32 warps an SM to hide the latency of its corner reads.
//
// Shared memory of a block: the staged window, if any, then a 32-byte
// record for each of the 8 (or G, if fewer) samples a lane group sets up at
// a time, 16 KB at d = 64.
//
// A head width that is not whole 16-byte units, or tensors that are not
// 16-byte aligned, take the scalar instance (V = 1: single elements over 32
// lanes, up to 4 rounds) of the same kernel.
#include "msda_tile.cuh"

namespace {

using namespace msda_tile;

// acc += bilinear(corners at p, p + sx, p + sy, p + sx + sy) for this lane's
// channels, the record's coefficients holding the attention weight; the
// corners are read from the staged window, or from device memory through
// the read-only path (L1)
template <int V, int G, int K, bool kGlobal>
__device__ __forceinline__ void blend_add(float (&acc)[K * V], const bf16* p,
                                          int sx, int sy, int lane_g, int d,
                                          const Record& r) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane_g + k * G) * V;
    if (c < d) {
      float v00[V], v01[V], v10[V], v11[V];
      load_slice<V, kGlobal>(v00, p + c);
      load_slice<V, kGlobal>(v01, p + c + sx);
      load_slice<V, kGlobal>(v10, p + c + sy);
      load_slice<V, kGlobal>(v11, p + c + sx + sy);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float t = fmaf(r.c00, v00[v], acc[k * V + v]);
        t = fmaf(r.c01, v01[v], t);
        t = fmaf(r.c10, v10[v], t);
        acc[k * V + v] = fmaf(r.c11, v11[v], t);
      }
    }
  }
}

// The next query's sums to the front: Q turns leave them where they were.
template <int Q, int N>
__device__ __forceinline__ void rotate(float (&acc)[Q][N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float first = acc[0][e];
#pragma unroll
    for (int i = 0; i + 1 < Q; ++i) acc[i][e] = acc[i + 1][e];
    acc[Q - 1][e] = first;
  }
}

// the staged window's bytes, whole 16-byte units: the records follow it
__host__ __device__ constexpr int stage_bytes(int stage_elems) {
  return (stage_elems * 2 + 15) / 16 * 16;
}

// kStage: the block stages each level's rectangle of its plan in shared
// memory and reads the corners that lie in it there (the production
// launches stage nothing: ops/msda.py STAGE_SHARE_FORWARD_BF16)
template <int V, int G, int K, bool kStage>
__global__ void __launch_bounds__(kThreads, 2)
msda_fwd_bf16_kernel(const bf16* __restrict__ value,
                     const int* __restrict__ levels,
                     const int* __restrict__ tiles,
                     const int* __restrict__ perm,
                     const float* __restrict__ pos,
                     const float* __restrict__ weight,
                     bf16* __restrict__ out,
                     int S, int Nq, int h, int d, int L, int P, int n_tiles,
                     int stage_elems) {
  extern __shared__ __align__(16) unsigned char shared[];
  bf16* stage = reinterpret_cast<bf16*>(shared);
  constexpr int kGroups = kThreads / G;
  constexpr int kWarpGroups = 32 / G;                   // lane groups a warp
  constexpr int kQueries = kMaxTileQueries / kGroups;   // a group's queries
  constexpr int kChunk = records_per_group(G);
  constexpr Rect kNone{0, 0, 0, 0};  // nothing staged

  const int head = blockIdx.x % h;
  const int bt = blockIdx.x / h;
  const int b = bt / n_tiles;
  const Tile tile(tiles, perm, bt, b, n_tiles, L);
  const int n_q = tile.th * tile.tw;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int warp_group = group - group % kWarpGroups;  // the warp's first
  const int hd = h * d;
  Record* records =
      reinterpret_cast<Record*>(shared +
                                (kStage ? stage_bytes(stage_elems) : 0)) +
      group * kChunk;

  // the sums of the group's queries group, group + kGroups, ...
  float acc[kQueries][K * V];
#pragma unroll
  for (int i = 0; i < kQueries; ++i)
#pragma unroll
    for (int e = 0; e < K * V; ++e) acc[i][e] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const bf16* vl =
        value + ((long long)b * S + levels[3 * l + 2]) * hd + head * d;
    const Rect r = kStage ? tile.rect(l) : kNone;
    if (kStage && r.rh > 0) {
      __syncthreads();  // the previous window has been sampled
      stage_window<V == 8 ? 4 : 1>(stage, vl, r, Wl, hd, d);
      __syncthreads();
    }
#pragma unroll 1
    for (int i = 0; i < kQueries; ++i) {
      // a warp whose groups hold no query of this turn skips it; a group
      // past the tile's last query in a warp that holds one runs on zeros
      // and stores nothing: the warp stays whole for __syncwarp
      if (warp_group + i * kGroups < n_q) {
        const int qi = group + i * kGroups;
        const bool active = qi < n_q;
        const long long qh =
            ((long long)b * Nq + (active ? tile.query(qi) : 0)) * h + head;
        const float* pp = pos + (qh * L + l) * P * 2;
        const float* wp = weight + (qh * L + l) * P;
        for (int s0 = 0; s0 < P; s0 += kChunk) {
          float x = 0.f, y = 0.f, a = 0.f;
          if (active && lane_g < kChunk && s0 + lane_g < P) {
            const float2 xy =
                __ldg(reinterpret_cast<const float2*>(pp) + s0 + lane_g);
            x = xy.x, y = xy.y;
            a = __ldg(wp + s0 + lane_g);
          }
          __syncwarp();  // the group has read its previous records
          if (lane_g < kChunk) {
            Record rec = setup_sample(x, y, a, Hl, Wl, r, d, hd).rec;
            rec.c00 *= a, rec.c01 *= a, rec.c10 *= a, rec.c11 *= a;
            store_record(records + lane_g, rec);
          }
          __syncwarp();
          const int n = min(kChunk, P - s0);
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const Record s = load_record(records + j);
            if (kStage && s.sy >= 0) {
              blend_add<V, G, K, false>(acc[0], stage + s.off, s.sx, s.sy,
                                        lane_g, d, s);
            } else {
              blend_add<V, G, K, true>(acc[0], vl + s.off, s.sx, -1 - s.sy,
                                       lane_g, d, s);
            }
          }
        }
      }
      rotate(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < kQueries; ++i) {
    const int qi = group + i * kGroups;
    if (qi < n_q) {
      const long long qh = ((long long)b * Nq + tile.query(qi)) * h + head;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (lane_g + k * G) * V;
        if (c < d) {
          float t[V];
#pragma unroll
          for (int v = 0; v < V; ++v) t[v] = acc[i][k * V + v];
          store_slice<V>(out + qh * d + c, t);
        }
      }
    }
  }
}

template <int V, int G, int K, bool kStage>
int launch(const bf16* value, const int* levels, const int* tiles,
           const int* perm, const float* pos, const float* weight, bf16* out,
           int B, int S, int Nq, int h, int d, int L, int P, int n_tiles,
           int stage_elems, cudaStream_t stream) {
  // the staged window, then the groups' records: 16 KB at most unstaged,
  // two blocks an SM leave L1 the rest
  const int smem = stage_bytes(stage_elems) +
                   kThreads / G * records_per_group(G) * kRecordBytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msda_fwd_bf16_kernel<V, G, K, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(msda_fwd_bf16_kernel<V, G, K, kStage>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)B * n_tiles * h;
  msda_fwd_bf16_kernel<V, G, K, kStage>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          value, levels, tiles, perm, pos, weight, out, S, Nq, h, d, L, P,
          n_tiles, stage_elems);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, h, d) and out (B, Nq, h·d) bf16; levels, tiles, perm, pos,
// weight and stage_elems (the plan's largest staged window in elements) as
// `msda_fwd` takes them (csrc/msda.cu); all contiguous, d <= 128, a level
// below 2^31 elements. stage_elems = 0 stages nothing and leaves the plan's
// rectangles unread. vec = 8 (16-byte slices over `lanes` = 4, 8 or 16
// lanes a query, 8·lanes >= d) needs d a multiple of 8 and value, out
// 16-byte aligned; vec = 1 takes single elements over 32 lanes. Returns the
// CUDA error of the launch, or cudaErrorInvalidValue for another instance.
extern "C" int msda_fwd_bf16(const bf16* value, const int* levels,
                             const int* tiles, const int* perm,
                             const float* pos, const float* weight, bf16* out,
                             int B, int S, int Nq, int h, int d, int L, int P,
                             int n_tiles, int stage_elems, int vec, int lanes,
                             void* stream) {
  if ((long long)B * n_tiles * h == 0 || d == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define MSDA_FWD_BF16(V, G, K)                                               \
  return stage_elems > 0                                                     \
             ? launch<V, G, K, true>(value, levels, tiles, perm, pos, weight, \
                                     out, B, S, Nq, h, d, L, P, n_tiles,     \
                                     stage_elems, st)                        \
             : launch<V, G, K, false>(value, levels, tiles, perm, pos,       \
                                      weight, out, B, S, Nq, h, d, L, P,     \
                                      n_tiles, 0, st)
  if (vec == 8 && lanes == 4) MSDA_FWD_BF16(8, 4, 1);
  if (vec == 8 && lanes == 8) MSDA_FWD_BF16(8, 8, 1);
  if (vec == 8 && lanes == 16) MSDA_FWD_BF16(8, 16, 1);
  if (vec == 1 && lanes == 32) MSDA_FWD_BF16(1, 32, 4);
#undef MSDA_FWD_BF16
  return (int)cudaErrorInvalidValue;
}
