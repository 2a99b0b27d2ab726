// Multi-level deformable sampling, backward (kernel C): the f32 instance,
// and through csrc/msda_bwd_bf16.cu, which includes this file with MSDA_T
// set, the bf16 instance.
//
// Replaces the Pallas TPU kernel `_kernel_bwd` of
// gedepth_tpu/ops/pallas/msda_windowed.py:898, launched by
// `msda_windowed_level_bwd_offw` (:967, pallas_call :1050) inside the custom
// VJPs `_levels_bwd` (:390), `_flanes_bwd` (:585) and `_group_bwd` (:1114).
// The TPU kernel produced only d_offsets and d_weights; the value gradient
// went through the XLA tiled VJP because Pallas could not scatter across
// overlapping windows (:880-895). Hopper can add into device memory from
// any thread, so one entry point (two kernels) emits all three gradients of
// the forward of csrc/msda.cu:
//
//   out[b, q, h·d + c] = Σ_l Σ_p w · Σ_ij cw_ij · v_ij[c]
//
// With g = dOut and s_ij = Σ_c g[c] · v_ij[c] (the four corner dots):
//   d_w   = Σ_ij cw_ij · s_ij
//   d_x   = w · [(1−fy)(s01 − s00) + fy (s11 − s10)]
//   d_y   = w · [(1−fx)(s10 − s00) + fx (s11 − s01)]
//   dV[corner ij][c] += w · cw_ij · g[c]
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
//
// The bf16 instance (`msda_bwd_bf16`) takes value and grad_out in bf16 and
// positions and weights in f32; d_pos and d_weight come out in f32. d_value
// is summed in an f32 buffer of the value's shape that the caller lends
// (`d_value_acc`), by the same binning, and rounded to bf16 once at the end
// by `round_kernel`: atomics on bf16 would round at every add.
//
// What bounds it on the H100, and the design: see the notes above the two
// kernels, `msda_bwd_pos_kernel` (d_pos, d_w) and `msda_bwd_value_kernel`
// (d_value).
#include "msda_tile.cuh"

#ifndef MSDA_T
#define MSDA_T float
#define MSDA_BWD_ENTRY msda_bwd
#endif

namespace {

using namespace msda_tile;

// Sums of four values over the G lanes of a group in 3 + log2(G/4) shuffles
// instead of 4·log2(G): the first exchange halves four values to two, the
// second to one, the rest is a butterfly. Every lane returns the total of
// corner 2·(lane_g / (G/2) % 2) + lane_g / (G/4) % 2, summed in a fixed
// order.
template <int G>
__device__ __forceinline__ float group_sum4(float s0, float s1, float s2,
                                            float s3, int lane_g) {
  constexpr int H1 = G / 2, H2 = G / 4;
  const bool up1 = lane_g & H1, up2 = lane_g & H2;
  float a = up1 ? s2 : s0, b = up1 ? s3 : s1;
  a += __shfl_xor_sync(kFullMask, up1 ? s0 : s2, H1);
  b += __shfl_xor_sync(kFullMask, up1 ? s1 : s3, H1);
  float t = up2 ? b : a;
  t += __shfl_xor_sync(kFullMask, up2 ? a : b, H2);
#pragma unroll
  for (int o = H2 / 2; o > 0; o >>= 1) t += __shfl_xor_sync(kFullMask, t, o);
  return t;
}

// The partial corner dots of one sample over this lane's channels.
template <int V, int G, int K, bool kGlobal, typename T>
__device__ __forceinline__ void corner_dots(const T* p, int sx, int sy,
                                            int lane_g, int d,
                                            const float (&g)[K * V],
                                            float (&s)[4]) {
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
        s[0] = fmaf(g[k * V + v], v00[v], s[0]);
        s[1] = fmaf(g[k * V + v], v01[v], s[1]);
        s[2] = fmaf(g[k * V + v], v10[v], s[2]);
        s[3] = fmaf(g[k * V + v], v11[v], s[3]);
      }
    }
  }
}

// d_pos and d_w. The first version ran one warp per (b, q, h) with two
// channels a lane: every lane redid the sample set-up, each corner dot took
// a full-warp reduction (20 shuffles a sample), and lane 0 wrote the
// results 4 bytes at a time; without its atomics it still took 7.2 of its
// 14.6 ms on the H100 (PERF.md). This kernel is the forward's twin
// (csrc/msda.cu): the same tiles and staged value windows, set-up once per
// sample, 16 bytes a lane; the four dots of a sample are reduced over the
// lane group by `group_sum4` (5 shuffles at d = 64), left in shared memory,
// and the lane that set the sample up forms d_w and d_pos from them, so
// those are written coalesced. Deterministic.
template <typename T, int V, int G, int K>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_pos_kernel(const T* __restrict__ value,
                    const int* __restrict__ levels,
                    const int* __restrict__ tiles,
                    const float* __restrict__ pos,
                    const float* __restrict__ weight,
                    const T* __restrict__ grad_out,
                    float* __restrict__ d_pos,
                    float* __restrict__ d_weight,
                    int S, int Nq, int h, int d, int L, int P, int n_tiles,
                    int stage_elems) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* stage = reinterpret_cast<T*>(shared);
  constexpr int kGroups = kThreads / G;
  constexpr int kChunk = records_per_group(G);

  const int head = blockIdx.x % h;
  const int bt = blockIdx.x / h;
  const int b = bt / n_tiles;
  const Tile tile(tiles, bt - b * n_tiles, L);
  const int n_q = tile.th * tile.tw;
  const int n_iter = (n_q + kGroups - 1) / kGroups;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int hd = h * d;
  // after the stage: per lane group kChunk records, then kChunk x 4 dots
  Record* records =
      reinterpret_cast<Record*>(stage + stage_elems) + group * kChunk;
  float4* dots = reinterpret_cast<float4*>(
                     reinterpret_cast<Record*>(stage + stage_elems) +
                     kGroups * kChunk) +
                 group * kChunk;

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const T* vl =
        value + ((long long)b * S + levels[3 * l + 2]) * hd + head * d;
    const Rect r = tile.rect(l);
    if (r.rh > 0) {
      __syncthreads();  // the previous window has been read
      stage_window<V>(stage, vl, r, Wl, hd, d);
      __syncthreads();
    }
    for (int it = 0; it < n_iter; ++it) {
      // a group past the tile's last query runs on zeros and writes nothing:
      // the warp stays whole for the shuffles
      const int qi = group + it * kGroups;
      const bool active = qi < n_q;
      const long long qh =
          ((long long)b * Nq + (active ? tile.query(qi) : 0)) * h + head;
      float g[K * V];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (lane_g + k * G) * V;
        float t[V];
#pragma unroll
        for (int v = 0; v < V; ++v) t[v] = 0.f;
        if (active && c < d) load_vec<V, true>(t, grad_out + qh * d + c);
#pragma unroll
        for (int v = 0; v < V; ++v) g[k * V + v] = t[v];
      }
      const long long row = (qh * L + l) * P;
      for (int s0 = 0; s0 < P; s0 += kChunk) {
        const bool live = active && lane_g < kChunk && s0 + lane_g < P;
        float x = 0.f, y = 0.f, a = 0.f;
        if (live) {
          const float2 xy = __ldg(
              reinterpret_cast<const float2*>(pos + row * 2) + s0 + lane_g);
          x = xy.x, y = xy.y;
          a = __ldg(weight + row + s0 + lane_g);
        }
        const Setup mine = setup_sample(x, y, a, Hl, Wl, r, d, hd);
        __syncwarp();  // the group has read its previous records and dots
        if (lane_g < kChunk) store_record(records + lane_g, mine.rec);
        __syncwarp();
        const int n = min(kChunk, P - s0);
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
          const Record s = load_record(records + j);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          if (s.sy >= 0) {
            corner_dots<V, G, K, false>(stage + s.off, s.sx, s.sy, lane_g, d,
                                        g, part);
          } else {
            corner_dots<V, G, K, true>(vl + s.off, s.sx, -1 - s.sy, lane_g, d,
                                       g, part);
          }
          const float total =
              group_sum4<G>(part[0], part[1], part[2], part[3], lane_g);
          if (lane_g % (G / 4) == 0)
            reinterpret_cast<float*>(dots + j)[lane_g / (G / 4)] = total;
        }
        __syncwarp();
        if (live) {
          // a corner outside the level was read at a clamped address: its
          // dot counts as zero
          const float4 t = dots[lane_g];
          const float s00 = mine.in00 ? t.x : 0.f, s01 = mine.in01 ? t.y : 0.f;
          const float s10 = mine.in10 ? t.z : 0.f, s11 = mine.in11 ? t.w : 0.f;
          const Record& c = mine.rec;
          d_weight[row + s0 + lane_g] =
              c.c00 * s00 + c.c01 * s01 + c.c10 * s10 + c.c11 * s11;
          reinterpret_cast<float2*>(d_pos + row * 2)[s0 + lane_g] = make_float2(
              a * ((1.f - mine.fy) * (s01 - s00) + mine.fy * (s11 - s10)),
              a * ((1.f - mine.fx) * (s10 - s00) + mine.fx * (s11 - s01)));
        }
      }
    }
  }
}

// p[0..V) += t[0..V) in device memory: 16 bytes an instruction for V = 4
// (sm_90's vector reduction).
template <int V>
__device__ __forceinline__ void add_vec(float* p, const float (&t)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(t[0], t[1], t[2], t[3]));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) atomicAdd(p + v, t[v]);
  }
}

// The four corners of a record, pixel units: offsets and coefficients.
struct Corners {
  int off[4];
  float c[4];
  __device__ __forceinline__ explicit Corners(const Record& r) {
    const int sy = r.sy >= 0 ? r.sy : -1 - r.sy;
    off[0] = r.off, off[1] = r.off + r.sx;
    off[2] = r.off + sy, off[3] = r.off + r.sx + sy;
    c[0] = r.c00, c[1] = r.c01, c[2] = r.c10, c[3] = r.c11;
  }
};

// d_value. The first version added w · cw_ij · g to device memory for
// every corner, channel and sample: 8.1 G float atomics at the train crop's
// cross-attention, half of its 14.6 ms, and the H100's L2 takes them no
// faster from 16-byte reductions (~5 TB/s of adds). Summing a window in
// shared memory with atomicAdd was worse still (28 ms: float adds on shared
// memory are compare-and-swap loops). So the sum is turned round. d_value
// needs no value, only (pixel, w · cw, g of the query). Per tile and level a
// block
//   1. counts, per pixel of the level's window, the corners that fall on it
//      (one thread a sample, native integer adds on shared memory),
//   2. turns the counts into bin starts (a scan by one warp),
//   3. files every corner as (query, w · cw) under its pixel,
//   4. gives each pixel to a lane group, which walks the pixel's bin,
//      multiplies the queries' g rows (staged once per tile in shared
//      memory) and adds the pixel's sum to device memory in one 16-byte
//      reduction per lane: one add per (tile, level, window pixel) that was
//      hit instead of one per corner.
// Samples that leave the window, and levels without one, add their corners
// to device memory directly (`direct_pass`). The order of a bin, and of the
// adds to device memory, changes from run to run, and d_value's low bits
// with it.
template <int V, int G, int K>
__device__ __forceinline__ void direct_pass(
    const Tile& tile, const Rect& r, const float* gs, Record* records,
    const float* pos, const float* weight, float* dvl, int Hl, int Wl, int b,
    int Nq, int h, int head, int d, int L, int l, int P) {
  constexpr int kGroups = kThreads / G;
  constexpr int kChunk = records_per_group(G);
  const int n_q = tile.th * tile.tw;
  const int n_iter = (n_q + kGroups - 1) / kGroups;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int hd = h * d;
  for (int it = 0; it < n_iter; ++it) {
    const int qi = group + it * kGroups;
    const bool active = qi < n_q;
    const long long row =
        ((((long long)b * Nq + (active ? tile.query(qi) : 0)) * h + head) * L +
         l) * P;
    for (int s0 = 0; s0 < P; s0 += kChunk) {
      float x = 0.f, y = 0.f, a = 0.f;
      if (active && lane_g < kChunk && s0 + lane_g < P) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(pos + row * 2) +
                                s0 + lane_g);
        x = xy.x, y = xy.y;
        a = __ldg(weight + row + s0 + lane_g);
      }
      __syncwarp();
      if (lane_g < kChunk)
        store_record(records + lane_g,
                     setup_sample(x, y, a, Hl, Wl, r, d, hd).rec);
      __syncwarp();
      const int n = min(kChunk, P - s0);
      for (int j = 0; j < n; ++j) {
        const Record s = load_record(records + j);
        if (s.sy >= 0 || !active) continue;  // filed under its pixel
        const Corners at(s);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = (lane_g + k * G) * V;
          if (c >= d) continue;
          float gq[V];
          load_vec<V, false>(gq, gs + qi * d + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (at.c[i] == 0.f) continue;  // outside the level
            float t[V];
#pragma unroll
            for (int v = 0; v < V; ++v) t[v] = s.a * gq[v] * at.c[i];
            add_vec<V>(dvl + at.off[i] + c, t);
          }
        }
      }
    }
  }
}

template <typename T, int V, int G, int K>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_value_kernel(const int* __restrict__ levels,
                      const int* __restrict__ tiles,
                      const float* __restrict__ pos,
                      const float* __restrict__ weight,
                      const T* __restrict__ grad_out,
                      float* __restrict__ d_value,
                      int S, int Nq, int h, int d, int L, int P, int n_tiles,
                      int stage_elems) {
  extern __shared__ __align__(16) unsigned char shared[];
  float* gs = reinterpret_cast<float*>(shared);
  constexpr int kGroups = kThreads / G;
  constexpr int kChunk = records_per_group(G);

  const int head = blockIdx.x % h;
  const int bt = blockIdx.x / h;
  const int b = bt / n_tiles;
  const Tile tile(tiles, bt - b * n_tiles, L);
  const int n_q = tile.th * tile.tw;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int hd = h * d;
  // the tile's g rows, the groups' records, the corner list (query, w·cw),
  // then per window pixel its count and its bin's start, and one counter
  const int max_px = stage_elems / d;
  Record* all_records =
      reinterpret_cast<Record*>(gs + round_up4(kMaxTileQueries * d));
  float2* list = reinterpret_cast<float2*>(all_records + kGroups * kChunk);
  int* count = reinterpret_cast<int*>(
      list + (stage_elems ? kMaxTileQueries * P * 4 : 0));
  int* start = count + max_px;
  int* n_far = start + max_px;

  for (int t = threadIdx.x; t < n_q * d; t += kThreads) {
    const int qi = t / d;
    gs[t] = to_float(ldg_elem(
        grad_out + (((long long)b * Nq + tile.query(qi)) * h + head) * d +
        (t - qi * d)));
  }

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    float* dvl =
        d_value + ((long long)b * S + levels[3 * l + 2]) * hd + head * d;
    const Rect r = tile.rect(l);
    const int n_px = r.rh * r.rw;
    __syncthreads();  // g rows staged; the previous level's bins were read
    if (n_px == 0) {
      direct_pass<V, G, K>(tile, r, gs, all_records + group * kChunk, pos,
                           weight, dvl, Hl, Wl, b, Nq, h, head, d, L, l, P);
      continue;
    }
    for (int t = threadIdx.x; t < n_px; t += kThreads) count[t] = 0;
    if (threadIdx.x == 0) *n_far = 0;
    __syncthreads();
    // 1. count (pass 0) and 3. file (pass 1) the corners, a thread a sample
    for (int pass = 0; pass < 2; ++pass) {
      for (int s = threadIdx.x; s < n_q * P; s += kThreads) {
        const int qi = s / P;
        const long long at =
            ((((long long)b * Nq + tile.query(qi)) * h + head) * L + l) * P +
            (s - qi * P);
        const float2 xy = __ldg(reinterpret_cast<const float2*>(pos) + at);
        const float a = __ldg(weight + at);
        // pixel units: d = 1
        const Record rec = setup_sample(xy.x, xy.y, a, Hl, Wl, r, 1, 1).rec;
        const Corners cs(rec);
        if (rec.sy < 0) {
          if (pass == 0 && (cs.c[0] != 0.f || cs.c[1] != 0.f ||
                            cs.c[2] != 0.f || cs.c[3] != 0.f))
            atomicAdd(n_far, 1);
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cs.c[i] == 0.f) continue;  // outside the level
          if (pass == 0) {
            atomicAdd(count + cs.off[i], 1);
          } else {
            list[atomicAdd(start + cs.off[i], 1)] =
                make_float2(__int_as_float(qi), a * cs.c[i]);
          }
        }
      }
      __syncthreads();
      if (pass == 0) {
        // 2. exclusive scan of the counts by the first warp
        if (threadIdx.x < 32) {
          int carry = 0;
          for (int base = 0; base < n_px; base += 32) {
            const int i = base + threadIdx.x;
            const int v = i < n_px ? count[i] : 0;
            int incl = v;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int up = __shfl_up_sync(kFullMask, incl, o);
              if ((int)threadIdx.x >= o) incl += up;
            }
            if (i < n_px) start[i] = carry + incl - v;
            carry += __shfl_sync(kFullMask, incl, 31);
          }
        }
        __syncthreads();
      }
    }
    // 4. a lane group a pixel; `start` now holds each bin's end
    for (int px = group; px < n_px; px += kGroups) {
      const int n = count[px];
      if (n == 0) continue;
      const int end = start[px];
      float acc[K * V];
#pragma unroll
      for (int v = 0; v < K * V; ++v) acc[v] = 0.f;
      for (int i = end - n; i < end; ++i) {
        const float2 rec = list[i];
        const float* gq = gs + __float_as_int(rec.x) * d;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = (lane_g + k * G) * V;
          if (c < d) {
            float t[V];
            load_vec<V, false>(t, gq + c);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[k * V + v] = fmaf(rec.y, t[v], acc[k * V + v]);
          }
        }
      }
      const int y = px / r.rw, x = px - y * r.rw;
      float* dst = dvl + ((r.y_lo + y) * Wl + r.x_lo + x) * hd;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (lane_g + k * G) * V;
        if (c < d) {
          float t[V];
#pragma unroll
          for (int v = 0; v < V; ++v) t[v] = acc[k * V + v];
          add_vec<V>(dst + c, t);
        }
      }
    }
    if (*n_far > 0)  // block-uniform: written before the last barrier
      direct_pass<V, G, K>(tile, r, gs, all_records + group * kChunk, pos,
                           weight, dvl, Hl, Wl, b, Nq, h, head, d, L, l, P);
  }
}

// d_value of the bf16 instance: the f32 sums rounded to nearest even, once
__global__ void round_kernel(const float* __restrict__ src,
                             bf16* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

__host__ __device__ constexpr int shared_bytes_pos(int stage_elems, int G,
                                                   int elem_bytes) {
  return stage_elems * elem_bytes +
         kThreads / G * records_per_group(G) *
             (kRecordBytes + (int)sizeof(float4));
}

__host__ __device__ constexpr int shared_bytes_value(int stage_elems, int G,
                                                     int d, int P) {
  return round_up4(kMaxTileQueries * d) * (int)sizeof(float) +
         kThreads / G * records_per_group(G) * kRecordBytes +
         (stage_elems ? kMaxTileQueries * P * 4 : 0) * (int)sizeof(float2) +
         (2 * (stage_elems / d) + 1) * (int)sizeof(int);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int V, int G, int K>
int launch(const T* value, const int* levels, const int* tiles,
           const float* pos, const float* weight, const T* grad_out,
           float* d_value, float* d_pos, float* d_weight, int B, int S, int Nq,
           int h, int d, int L, int P, int n_tiles, int stage_elems,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long long)B * n_tiles * h);
  int smem = shared_bytes_pos(stage_elems, G, (int)sizeof(T));
  cudaError_t e = allow_shared(msda_bwd_pos_kernel<T, V, G, K>, smem);
  if (e != cudaSuccess) return (int)e;
  msda_bwd_pos_kernel<T, V, G, K><<<blocks, kThreads, smem, stream>>>(
      value, levels, tiles, pos, weight, grad_out, d_pos, d_weight, S, Nq, h,
      d, L, P, n_tiles, stage_elems);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  smem = shared_bytes_value(stage_elems, G, d, P);
  e = allow_shared(msda_bwd_value_kernel<T, V, G, K>, smem);
  if (e != cudaSuccess) return (int)e;
  msda_bwd_value_kernel<T, V, G, K><<<blocks, kThreads, smem, stream>>>(
      levels, tiles, pos, weight, grad_out, d_value, S, Nq, h, d, L, P,
      n_tiles, stage_elems);
  return (int)cudaGetLastError();
}

// the f32 instance sums into d_value itself
inline int finish(const float*, float*, long long, cudaStream_t) {
  return (int)cudaSuccess;
}
inline int finish(const float* acc, bf16* d_value, long long n,
                  cudaStream_t stream) {
  round_kernel<<<1024, 256, 0, stream>>>(acc, d_value, n);
  return (int)cudaGetLastError();
}

template <typename T, int V, int G, int K>
int run(const T* value, const int* levels, const int* tiles, const float* pos,
        const float* weight, const T* grad_out, float* d_value_acc,
        T* d_value, float* d_pos, float* d_weight, int B, int S, int Nq, int h,
        int d, int L, int P, int n_tiles, int stage_elems,
        cudaStream_t stream) {
  const int err = launch<T, V, G, K>(value, levels, tiles, pos, weight,
                                     grad_out, d_value_acc, d_pos, d_weight, B,
                                     S, Nq, h, d, L, P, n_tiles, stage_elems,
                                     stream);
  if (err != 0) return err;
  return finish(d_value_acc, d_value, (long long)B * S * h * d, stream);
}

}  // namespace

// value (B, S, h, d) and grad_out (B, Nq, h·d) of MSDA_T (float for
// `msda_bwd`, __nv_bfloat16 for `msda_bwd_bf16`); levels, tiles, pos, weight,
// vec, lanes and stage_elems as `msda_fwd` takes them (csrc/msda.cu);
// outputs d_value (B, S, h, d) of MSDA_T, d_pos and d_weight f32 in the
// shapes of pos and weight; d_value_acc: f32, the value's shape, zeroed here
// and summed into (for `msda_bwd` it is d_value itself; for `msda_bwd_bf16`
// a buffer the caller lends, rounded into d_value at the end); all
// contiguous; vec = 4 also needs grad_out, d_value and d_value_acc 16-byte
// aligned. Launches on `stream` the memset of d_value_acc, the two kernels
// and, for bf16, the rounding; returns the CUDA error, or
// cudaErrorInvalidValue for another instance.
extern "C" int MSDA_BWD_ENTRY(const MSDA_T* value, const int* levels,
                              const int* tiles, const float* pos,
                              const float* weight, const MSDA_T* grad_out,
                              float* d_value_acc, MSDA_T* d_value,
                              float* d_pos, float* d_weight, int B, int S,
                              int Nq, int h, int d, int L, int P, int n_tiles,
                              int stage_elems, int vec, int lanes,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t acc_bytes = (size_t)B * S * h * d * sizeof(float);
  cudaError_t err = cudaMemsetAsync(d_value_acc, 0, acc_bytes, st);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * n_tiles * h == 0 || d == 0)
    return finish(d_value_acc, d_value, (long long)B * S * h * d, st);
#define MSDA_BWD(V, G, K)                                                     \
  return run<MSDA_T, V, G, K>(value, levels, tiles, pos, weight, grad_out,    \
                              d_value_acc, d_value, d_pos, d_weight, B, S,    \
                              Nq, h, d, L, P, n_tiles, stage_elems, st)
  if (vec == 4 && lanes == 4) MSDA_BWD(4, 4, 1);
  if (vec == 4 && lanes == 8) MSDA_BWD(4, 8, 1);
  if (vec == 4 && lanes == 16) MSDA_BWD(4, 16, 1);
  if (vec == 4 && lanes == 32) MSDA_BWD(4, 32, 1);
  if (vec == 1 && lanes == 32) MSDA_BWD(1, 32, 4);
#undef MSDA_BWD
  return (int)cudaErrorInvalidValue;
}
