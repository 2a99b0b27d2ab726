// Multi-level deformable sampling, forward (kernel B): the f32 instance, and
// through csrc/msda_bf16.cu, which includes this file with MSDA_T set, the
// bf16 instance.
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
// the 11x38 grid sampling 88x304) went to an XLA fallback. Hopper gathers,
// so this kernel reads the four corners of every sample, from a staged
// window in shared memory where the plan has one and from device memory
// otherwise, in the same launch.
//
// Shapes at the serving slice's full width (352x1216, batch 1): value
// (1, 35530, 8, 64) over levels 88x304, 44x152, 22x76, 11x38; L = 4, P = 8;
// self-attention 8,778 queries, cross-attention 107,008 queries (176x608).
//
//
// The bf16 instance (`msda_fwd_bf16`) takes the value and writes the output
// in bf16; positions and attention weights stay f32 (a bf16 position on a
// 304-pixel level has a quarter-pixel grid). It stages its windows in bf16,
// so the same shared memory holds twice the pixels, reads a corner as 4
// bf16 (8 bytes a lane: the lane groups stay those of the f32 instance),
// sums in f32 in the order of `blend_add` and rounds once at the store.
//
// What bounds it on the H100, and the design: see the note above the kernel.
#include "msda_tile.cuh"

#ifndef MSDA_T
#define MSDA_T float
#define MSDA_FWD_ENTRY msda_fwd
#endif

namespace {

using namespace msda_tile;

// acc += a · bilinear(corners at p, p + sx, p + sy, p + sx + sy) for this
// lane's channels: the corner blend, then one fma of the attention weight
// into the sum. The blend rounds c01·v01 and fuses the other three products,
// which is what the compiler made of the first version's expression: this
// kernel equals that one bit for bit. The order matters downstream: with
// c00·v00 rounded instead (2.4e-7 away at most), a train step's gradient
// for the cross-attention's output bias moved from 4e-6 to 3e-4 of its
// norm against the plain versions (PERF.md).
template <int V, int G, int K, bool kGlobal, typename T>
__device__ __forceinline__ void blend_add(float (&acc)[K * V], const T* p,
                                          int sx, int sy, int lane_g, int d,
                                          const Record& r) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane_g + k * G) * V;
    if (c < d) {
      float v00[V], v01[V], v10[V], v11[V];
      load_vec<V, kGlobal>(v00, p + c);
      load_vec<V, kGlobal>(v01, p + c + sx);
      load_vec<V, kGlobal>(v10, p + c + sy);
      load_vec<V, kGlobal>(v11, p + c + sx + sy);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = r.c01 * v01[v];
        s = fmaf(r.c00, v00[v], s);
        s = fmaf(r.c10, v10[v], s);
        s = fmaf(r.c11, v11[v], s);
        acc[k * V + v] = fmaf(r.a, s, acc[k * V + v]);
      }
    }
  }
}

// What bounds it, and the design. The first version ran one thread per
// (b, q, h, c): every channel of a query redid the sample's floor, bounds
// tests and corner weights and read 4 bytes a thread. Measured on the H100
// (PERF.md), that instruction stream, not the memory, held it: with every
// corner read pointed at four rows it still took 6.6 of its 8.4 ms. Here
//   - a query's channels lie over G lanes of 16 bytes; one lane sets up each
//     sample of a (query, level) once and the group reads it back from
//     shared memory, so a sample costs a lane two record reads, four corner
//     reads and 20 FMAs;
//   - a block owns a tile of one query grid and one head (msda_tile.cuh) and
//     walks the levels; for each it stages the value window its queries can
//     reach in shared memory (cp.async, 16 bytes), so a corner read is a
//     shared-memory read and device memory sees each window once per tile;
//   - the tile's running sums wait in shared memory between levels, so the
//     query loop needs no registers per query and is not unrolled: an
//     unrolled one ran slower the more it was unrolled (its code outgrew the
//     instruction cache), and 64 registers a thread let two blocks of 16
//     warps share an SM, one sampling while the other stages;
//   - a level whose window does not fit (a coarse query grid over a fine
//     level) and any sample that leaves its window read device memory in
//     the same loop.
// A call without a radius (the exact rule, which six presets sample) takes
// its tiles from the plan the card makes of its positions
// (csrc/msda_plan.cu): 128 queries in the order of their samples' centres,
// read through `perm`, each row written at its query's own index. Before
// that plan every corner of such a call came from device memory, in query
// order, and learned reference points sent neighbouring lane groups all
// over the level: 2.87 ms at the serving cross-attention, 13x its bound.
// The plan (~5% of the call) buys back locality and the staged windows;
// what is left is the forward's design as above, and at the self-attention,
// whose grid-centre anchors were already local, only the plan's cost.
// Fetching a query's samples one iteration ahead made it 5% slower: the 32
// warps of an SM already hide that latency. Deterministic: no atomics; per
// channel the samples are summed over l, p ascending with the first
// version's arithmetic.
template <typename T, int V, int G, int K>
__global__ void __launch_bounds__(kThreads, 2)
msda_fwd_kernel(const T* __restrict__ value,
                const int* __restrict__ levels,
                const int* __restrict__ tiles,
                const int* __restrict__ perm,
                const float* __restrict__ pos,
                const float* __restrict__ weight,
                T* __restrict__ out,
                int S, int Nq, int h, int d, int L, int P, int n_tiles,
                int stage_elems) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* stage = reinterpret_cast<T*>(shared);
  constexpr int kGroups = kThreads / G;
  constexpr int kChunk = records_per_group(G);

  const int head = blockIdx.x % h;
  const int bt = blockIdx.x / h;
  const int b = bt / n_tiles;
  const Tile tile(tiles, perm, bt, b, n_tiles, L);
  const int n_q = tile.th * tile.tw;
  const int n_iter = (n_q + kGroups - 1) / kGroups;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int hd = h * d;
  // after the stage (whole 16-byte units): the tile's running sums, d floats
  // a query, then kChunk records for each lane group
  float* sums = reinterpret_cast<float*>(stage + stage_elems);
  Record* records =
      reinterpret_cast<Record*>(sums + round_up4(kMaxTileQueries * d)) +
      group * kChunk;

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const T* vl =
        value + ((long long)b * S + levels[3 * l + 2]) * hd + head * d;
    const Rect r = tile.rect(l);
    if (r.rh > 0) {
      __syncthreads();  // the previous window has been sampled
      stage_window<V>(stage, vl, r, Wl, hd, d);
      __syncthreads();
    }
    for (int it = 0; it < n_iter; ++it) {
      // a group past the tile's last query runs on zeros and stores nothing:
      // the warp stays whole for __syncwarp
      const int qi = group + it * kGroups;
      const bool active = qi < n_q;
      const long long qh =
          ((long long)b * Nq + (active ? tile.query(qi) : 0)) * h + head;
      float* mine = sums + qi * d;
      float acc[K * V];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (lane_g + k * G) * V;
        float t[V];
#pragma unroll
        for (int v = 0; v < V; ++v) t[v] = 0.f;
        if (l > 0 && active && c < d) load_vec<V, false>(t, mine + c);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[k * V + v] = t[v];
      }
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
        if (lane_g < kChunk)
          store_record(records + lane_g,
                       setup_sample(x, y, a, Hl, Wl, r, d, hd).rec);
        __syncwarp();
        const int n = min(kChunk, P - s0);
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
          const Record s = load_record(records + j);
          if (s.sy >= 0) {
            blend_add<V, G, K, false>(acc, stage + s.off, s.sx, s.sy, lane_g,
                                      d, s);
          } else {
            blend_add<V, G, K, true>(acc, vl + s.off, s.sx, -1 - s.sy, lane_g,
                                     d, s);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = (lane_g + k * G) * V;
          if (c < d) {
            float t[V];
#pragma unroll
            for (int v = 0; v < V; ++v) t[v] = acc[k * V + v];
            if (l == L - 1) {
              store_vec<V>(out + qh * d + c, t);
            } else {
              store_vec<V>(mine + c, t);
            }
          }
        }
      }
    }
  }
}

template <typename T, int V, int G, int K>
int launch(const T* value, const int* levels, const int* tiles,
           const int* perm, const float* pos, const float* weight, T* out,
           int B, int S, int Nq, int h, int d, int L, int P, int n_tiles,
           int stage_elems, cudaStream_t stream) {
  // the staged window, the tile's running sums, the groups' records
  const int smem =
      stage_elems * (int)sizeof(T) +
      round_up4(kMaxTileQueries * d) * (int)sizeof(float) +
      kThreads / G * records_per_group(G) * kRecordBytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msda_fwd_kernel<T, V, G, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(msda_fwd_kernel<T, V, G, K>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)B * n_tiles * h;
  msda_fwd_kernel<T, V, G, K><<<(unsigned)blocks, kThreads, smem, stream>>>(
      value, levels, tiles, perm, pos, weight, out, S, Nq, h, d, L, P, n_tiles,
      stage_elems);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, h, d) of MSDA_T (float for `msda_fwd`, __nv_bfloat16 for
// `msda_fwd_bf16`); levels (L, 3) int32 rows (H, W, start); tiles and
// perm, the plan for lane groups of `lanes`: perm null and tiles
// (n_tiles, 6 + 4·L) int32 from ops/msda.py `tile_plan`, the same rows for
// every batch entry, or perm (B, Nq) and tiles (B·n_tiles, 6 + 4·L) int32
// from `msda_plan` (csrc/msda_plan.cu), n_tiles rows an entry; pos (B, Nq,
// h, L, P, 2) f32, 8-byte aligned; weight (B, Nq, h, L, P) f32; out (B, Nq,
// h·d) of MSDA_T; all contiguous, d <= 128,
// a level below 2^31 elements. `vec` = 4 (d a multiple of 4 floats or 8
// bf16 and value, out 16-byte aligned; lanes = 4, 8, 16 or 32 with
// 4·lanes >= d) or 1 (lanes = 32). `stage_elems`: the plan's largest staged
// window in elements, whole 16-byte units. Returns the CUDA error of the
// launch, or cudaErrorInvalidValue for another instance.
extern "C" int MSDA_FWD_ENTRY(const MSDA_T* value, const int* levels,
                              const int* tiles, const int* perm,
                              const float* pos, const float* weight,
                              MSDA_T* out, int B, int S,
                              int Nq, int h, int d, int L, int P, int n_tiles,
                              int stage_elems, int vec, int lanes,
                              void* stream) {
  if ((long long)B * n_tiles * h == 0 || d == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define MSDA_FWD(V, G, K)                                                   \
  return launch<MSDA_T, V, G, K>(value, levels, tiles, perm, pos, weight,   \
                                 out, B, S, Nq, h, d, L, P, n_tiles,        \
                                 stage_elems, st)
  if (vec == 4 && lanes == 4) MSDA_FWD(4, 4, 1);
  if (vec == 4 && lanes == 8) MSDA_FWD(4, 8, 1);
  if (vec == 4 && lanes == 16) MSDA_FWD(4, 16, 1);
  if (vec == 4 && lanes == 32) MSDA_FWD(4, 32, 1);
  if (vec == 1 && lanes == 32) MSDA_FWD(1, 32, 4);
#undef MSDA_FWD
  return (int)cudaErrorInvalidValue;
}
