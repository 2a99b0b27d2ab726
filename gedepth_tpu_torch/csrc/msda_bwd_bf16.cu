// Multi-scale deformable sampling, backward (kernel C), for a bf16 value
// and a bf16 grad_out: d_value in bf16, d_pos and d_weights in f32.
//
// Replaces, for bf16 tensors, the Pallas TPU kernel `_kernel_bwd` of
// gedepth_tpu/ops/pallas/msda_windowed.py:898, launched by
// `msda_windowed_level_bwd_offw` (:967, pallas_call :1050). As the f32
// instance (csrc/msda_bwd.cu, whose note gives the gradients' formulas), it
// emits all three gradients of the forward of csrc/msda.cu; the TPU kernel
// left d_value to XLA.
//
// What bounds it on the H100. At the train crop's cross-attention (value
// (2, 20570, 8, 64) bf16, grad_out (2, 61952, 512) bf16, pos (2, 61952, 8,
// 4, 8, 2) f32) the work is 17 f32 operations a touching sample and channel
// on the CUDA cores, 0.48 ms at 67 TFLOP/s, against 0.3 ms for its bytes:
// operations bound it. The f32 source compiled for bf16 took 4.72 ms there,
// as long as the f32 instance (4.79): it read bf16 in 8-byte slices over
// the f32 lane groups (16 lanes a query at d = 64), and it ran two kernels,
// one for d_pos and d_w and one for d_value, each of which set every sample
// up again and read pos, weights (381 MB at that shape) and the grad_out
// rows once more.
//
// The design (device ms at that shape on the H100 from chip_smoke.py phase
// 13: 3.61 against the f32 instance's 4.87 in the same process):
//   * 16-byte slices of 8 bf16: a query's d channels lie over G = d / 8
//     lanes (8 at d = 64), and every corner read from the staged window or
//     from device memory is one 16-byte load. Corner dots are f32 sums.
//   * one pass: a block stages the tile's grad_out rows once (bf16, for all
//     levels) and, per level, the value window. Lane j of a group sets
//     sample j up once (floor, bounds, coefficients, offset: the record of
//     csrc/msda_tile.cuh), the group forms the four corner dots, which give
//     d_w and d_pos (written by lane j, deterministic), and lane j files the
//     sample's corners for d_value. pos and weights are read once.
//   * d_value's sums: a corner inside its tile's window is filed as (pixel
//     of the window, query of the tile, w·cw) and counted by pixel (native
//     integer atomics on shared memory); after the level the block sorts
//     the filed corners by pixel (a scan of the counts, a scatter) into the
//     region the window took, and each lane group takes an equal run of the
//     sorted corners, sums w·cw times the query's g row while the pixel
//     stays and adds the sum to device memory when it changes, 16 bytes a
//     reduction: about one add per (tile, level, hit pixel) instead of one
//     per corner, with the same work for every group. Lists linked through
//     the pixels and walked a group a pixel were slower: each step of a
//     walk waited on the last, and a warp waited on its longest list.
//   * a window that outgrows the stage but not BIN_PIXELS_BACKWARD (the
//     plan marks it with a negative height: the train crop's self-attention
//     on the 88x176 level) is binned alone: its corners are read from
//     device memory and filed as a staged window's. Where neither holds, a
//     corner is added to device memory from the dot pass's registers,
//     which cost the self-attention more than the f32 instance's time
//     before its windows were binned.
//   * the f32 sum across tiles: neighbouring tiles' windows overlap, so the
//     sums of different blocks meet in device memory and d_value is summed
//     in an f32 buffer of the value's shape that the caller lends, zeroed
//     by a memset and rounded to bf16 once by `round_kernel` (atomics on
//     bf16 would round at every add). At the train crop that buffer is 84
//     MB: the memset writes it, the round reads it and writes the 42 MB of
//     bf16, 210 MB, 0.063 ms at 3.35 TB/s, under 2% of the kernel. The
//     order of a bin, and of the adds, changes from run to run, and
//     d_value's low bits with it; d_pos and d_w do not.
//   * the kernel stays at 64 registers with a few spills: two samples'
//     dots reduced together, or four sorted corners loaded at once, spilled
//     more and ran slower; 384 threads a block (80 registers, no spills)
//     ran no faster.
// What bounds it now: latency and issue of the dot pass and of the walk
// (7.5x the operations' bound at the train crop's cross-attention).
//
// Shared memory of a block (mirrored by `shared_bytes_backward` in
// gedepth_tpu_torch/ops/msda.py, which sizes the plan's windows so that two
// blocks of 512 threads share an SM): a region that holds the staged bf16
// window and then the sorted corners, the tile's bf16 g rows, a 32-byte
// record for each of the 8 samples a lane group sets up at a time (which
// then holds the sample's four dots), and, where the launch bins, 4 corner
// slots of 8 bytes a sample of each of the tile's queries, a count per
// pixel of the largest bin window and the count of the filed corners.
//
// A head width that is not whole 16-byte units, or tensors that are not
// 16-byte aligned, take the scalar instance (V = 1: single elements over 32
// lanes, up to 4 rounds) of the same kernel.
#include "msda_tile.cuh"

namespace {

using namespace msda_tile;

constexpr int kCornersPerSample = 4;

__host__ __device__ constexpr int round_up8(int n) { return (n + 7) / 8 * 8; }

// Bytes of the region that holds the staged window in the dot pass and the
// corners sorted by pixel in the walk: the larger of the two.
__host__ __device__ constexpr int region_bytes(int stage_elems, int n_slots) {
  return stage_elems * 2 > n_slots * 8 ? stage_elems * 2 : n_slots * 8;
}

// V bf16 from p as floats: one 16-byte load for V = 8
template <int V, bool kGlobal>
__device__ __forceinline__ void load_slice(float (&dst)[V], const bf16* p) {
  if constexpr (V == 8) {
    uint4 t;
    if constexpr (kGlobal) {
      t = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      t = *reinterpret_cast<const uint4*>(p);
    }
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = __uint_as_float(u[i] << 16);
      dst[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int v = 0; v < V; ++v)
      dst[v] = __uint_as_float((unsigned)(kGlobal ? __ldg(s + v) : s[v])
                               << 16);
  }
}

// p[0..V) += t[0..V) in device memory: 16 bytes an instruction (sm_90's
// vector reduction) for V = 8
template <int V>
__device__ __forceinline__ void add_slice(float* p, const float (&t)[V]) {
  if constexpr (V == 8) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(t[0], t[1], t[2], t[3]));
    atomicAdd(reinterpret_cast<float4*>(p + 4),
              make_float4(t[4], t[5], t[6], t[7]));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) atomicAdd(p + v, t[v]);
  }
}

// Sums of four values over the G lanes of a group, as csrc/msda_bwd.cu's
// `group_sum4`: every lane returns the total of corner lane_g / (G/4).
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

// The four corners of a record: element offsets from p and coefficients.
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

// The lane's partial corner dots of one sample and, for a sample outside
// the staged window (kGlobal), its corners' share of d_value added to
// device memory at dvl: w·cw·g.
template <int V, int G, int K, bool kGlobal>
__device__ __forceinline__ void sample_pass(const bf16* p, float* dvl,
                                            const Record& s, bool active,
                                            int lane_g, int d,
                                            const float (&g)[K * V],
                                            float (&dot)[4]) {
  const Corners at(s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane_g + k * G) * V;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[V];
        load_slice<V, kGlobal>(v, p + at.off[i] + c);
#pragma unroll
        for (int e = 0; e < V; ++e) dot[i] = fmaf(g[k * V + e], v[e], dot[i]);
      }
      if constexpr (kGlobal) {
        if (active && s.a != 0.f) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (at.c[i] == 0.f) continue;  // outside the level
            const float wc = s.a * at.c[i];
            float t[V];
#pragma unroll
            for (int e = 0; e < V; ++e) t[e] = wc * g[k * V + e];
            add_slice<V>(dvl + at.off[i] + c, t);
          }
        }
      }
    }
  }
}

// Window pixel px's sums (this lane's channels) added to the level's
// d_value, 16 bytes a reduction for V = 8; the sums are zeroed.
template <int V, int G, int K>
__device__ __forceinline__ void add_pixel(float* dvl, float (&acc)[K * V],
                                          int px, const Rect& r, int Wl,
                                          int hd, int lane_g, int d) {
  const int y = px / r.rw, x = px - y * r.rw;
  float* dst = dvl + ((long long)(r.y_lo + y) * Wl + r.x_lo + x) * hd;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane_g + k * G) * V;
    if (c < d) {
      float t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = acc[k * V + v], acc[k * V + v] = 0.f;
      add_slice<V>(dst + c, t);
    }
  }
}

template <int V, int G, int K>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_bf16_kernel(const bf16* __restrict__ value,
                     const int* __restrict__ levels,
                     const int* __restrict__ tiles,
                     const int* __restrict__ perm,
                     const float* __restrict__ pos,
                     const float* __restrict__ weight,
                     const bf16* __restrict__ grad_out,
                     float* __restrict__ d_value,
                     float* __restrict__ d_pos,
                     float* __restrict__ d_weight,
                     int S, int Nq, int h, int d, int L, int P, int n_tiles,
                     int stage_elems, int bin_px) {
  extern __shared__ __align__(16) unsigned char shared[];
  constexpr int kGroups = kThreads / G;
  constexpr int kWarpGroups = 32 / G;  // lane groups a warp
  constexpr int kChunk = records_per_group(G);

  const int head = blockIdx.x % h;
  const int bt = blockIdx.x / h;
  const int b = bt / n_tiles;
  const Tile tile(tiles, perm, bt, b, n_tiles, L);
  const int n_q = tile.th * tile.tw;
  // a group's item: a query of the tile and a run of `sub` of its samples,
  // kChunk (one a lane that sets up) or, where the tile has too few
  // queries to give every group one, fewer
  int sub = kChunk;
  while (sub > 1 && n_q * ((P + sub - 1) / sub) * 2 <= kGroups) sub /= 2;
  const int per_query = (P + sub - 1) / sub;
  const int n_items = n_q * per_query;
  const int n_iter = (n_items + kGroups - 1) / kGroups;
  const int group = threadIdx.x / G, lane_g = threadIdx.x % G;
  const int hd = h * d;
  // the window (in the walk: the corners sorted by pixel), the tile's g
  // rows, the groups' records (each, once the group has read it, holds its
  // sample's four dots), the filed corners, per pixel of the bin window
  // its count (then its bin's start, then its end), and the count of the
  // filed corners
  const int n_slots = bin_px ? kMaxTileQueries * P * kCornersPerSample : 0;
  bf16* stage = reinterpret_cast<bf16*>(shared);
  int2* sorted = reinterpret_cast<int2*>(shared);
  bf16* gs = reinterpret_cast<bf16*>(
      shared + region_bytes(stage_elems, n_slots));
  Record* records =
      reinterpret_cast<Record*>(gs + round_up8(kMaxTileQueries * d));
  int2* filed = reinterpret_cast<int2*>(records + kGroups * kChunk);
  int* count = reinterpret_cast<int*>(filed + n_slots);
  int* n_filed = count + bin_px;
  records += group * kChunk;

  // the tile's g rows, once for every level: 16-byte copies for V = 8
  {
    constexpr int E = V == 8 ? 8 : 1;
    const int chunks = d / E;
    for (int t = threadIdx.x; t < n_q * chunks; t += kThreads) {
      const int qi = t / chunks, c = (t - qi * chunks) * E;
      const bf16* src =
          grad_out + (((long long)b * Nq + tile.query(qi)) * h + head) * d + c;
      if constexpr (V == 8) {
        cp_async16(gs + qi * d + c, src);
      } else {
        gs[qi * d + c] = ldg_elem(src);
      }
    }
    if constexpr (V == 8) cp_async_wait_all();
  }

  for (int l = 0; l < L; ++l) {
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const long long level_at = ((long long)b * S + levels[3 * l + 2]) * hd +
                               head * d;
    const bf16* vl = value + level_at;
    float* dvl = d_value + level_at;
    // rh > 0: the window is staged and its corners binned; rh < 0: binned
    // alone (the window outgrows the stage, its corners are read from
    // device memory); 0: neither
    const Rect r = tile.rect(l);
    const Rect bins{r.y_lo, r.x_lo, r.rh < 0 ? -r.rh : r.rh, r.rw};
    const int n_px = bins.rh * bins.rw;
    __syncthreads();  // g rows landed; the previous level's lists were read
    if (n_px > 0) {
      if (r.rh > 0) stage_window<V == 8 ? 4 : 1>(stage, vl, r, Wl, hd, d);
      for (int t = threadIdx.x; t < n_px; t += kThreads) count[t] = 0;
      if (threadIdx.x == 0) *n_filed = 0;
      __syncthreads();
    }
    for (int it = 0; it < n_iter; ++it) {
      // a warp whose groups hold no item is done; a group past the last
      // item in a warp that holds one runs on zeros and writes nothing:
      // the warp stays whole for the shuffles
      const int item = group + it * kGroups;
      if (item - group % kWarpGroups >= n_items) break;
      const bool active = item < n_items;
      const int qi = active ? item / per_query : 0;
      const int s0 = active ? (item - qi * per_query) * sub : 0;
      const long long qh =
          ((long long)b * Nq + (active ? tile.query(qi) : 0)) * h + head;
      float g[K * V];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (lane_g + k * G) * V;
        float t[V];
#pragma unroll
        for (int e = 0; e < V; ++e) t[e] = 0.f;
        if (active && c < d) load_slice<V, false>(t, gs + qi * d + c);
#pragma unroll
        for (int e = 0; e < V; ++e) g[k * V + e] = t[e];
      }
      const long long row = (qh * L + l) * P + s0;
      const bool live = active && lane_g < sub && s0 + lane_g < P;
      float x = 0.f, y = 0.f, a = 0.f;
      if (live) {
        const float2 xy =
            __ldg(reinterpret_cast<const float2*>(pos + row * 2) + lane_g);
        x = xy.x, y = xy.y;
        a = __ldg(weight + row + lane_g);
      }
      __syncwarp();  // the group has read its previous records
      if (lane_g < sub) {
        Record rec = setup_sample(x, y, a, Hl, Wl, r, d, hd).rec;
        // a sample of a window binned alone is read from device memory
        // and filed below: weight 0 keeps its corners out of the direct
        // adds
        if (r.rh < 0 && setup_sample(x, y, a, Hl, Wl, bins, 1, 1).rec.sy >= 0)
          rec.a = 0.f;
        store_record(records + lane_g, rec);
      }
      __syncwarp();
      const int n = P - s0;  // samples of the item, if fewer than `sub`
      const int n_j = min(sub, P);
      for (int j = 0; j < n_j; ++j) {
        const Record s = load_record(records + j);
        const bool real = active && j < n;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        if (s.sy >= 0) {
          sample_pass<V, G, K, false>(stage, dvl, s, real, lane_g, d, g, dot);
        } else {
          sample_pass<V, G, K, true>(vl, dvl, s, real, lane_g, d, g, dot);
        }
        const float total =
            group_sum4<G>(dot[0], dot[1], dot[2], dot[3], lane_g);
        __syncwarp();  // every lane has read record j: its first 16 bytes
                       // now take the four dots
        if (lane_g % (G / 4) == 0)
          reinterpret_cast<float*>(records + j)[lane_g / (G / 4)] = total;
      }
      __syncwarp();
      if (live) {
        // the set-up again (kept in registers it would crowd the loop's),
        // then its dots; a corner outside the level was read at a clamped
        // address: its dot counts as zero
        const Setup mine = setup_sample(x, y, a, Hl, Wl, r, d, hd);
        const float4 t = *reinterpret_cast<const float4*>(records + lane_g);
        const float s00 = mine.in00 ? t.x : 0.f, s01 = mine.in01 ? t.y : 0.f;
        const float s10 = mine.in10 ? t.z : 0.f, s11 = mine.in11 ? t.w : 0.f;
        const Record& c = mine.rec;
        d_weight[row + lane_g] =
            c.c00 * s00 + c.c01 * s01 + c.c10 * s10 + c.c11 * s11;
        reinterpret_cast<float2*>(d_pos + row * 2)[lane_g] = make_float2(
            a * ((1.f - mine.fy) * (s01 - s00) + mine.fy * (s11 - s10)),
            a * ((1.f - mine.fx) * (s10 - s00) + mine.fx * (s11 - s01)));
        // the sample's corners in the bin window, in pixels of it
        const Record in = setup_sample(x, y, a, Hl, Wl, bins, 1, 1).rec;
        if (n_px > 0 && in.sy >= 0) {
          // file them: (pixel << 7 | query, w·cw), counted by pixel
          const int px[4] = {in.off, in.off + in.sx, in.off + in.sy,
                             in.off + in.sx + in.sy};
          const float cw[4] = {c.c00, c.c01, c.c10, c.c11};
          int at = atomicAdd(n_filed, (cw[0] != 0.f) + (cw[1] != 0.f) +
                                          (cw[2] != 0.f) + (cw[3] != 0.f));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (cw[i] == 0.f) continue;  // outside the level
            atomicAdd(count + px[i], 1);
            filed[at++] = make_int2((px[i] << 7) | qi,
                                    __float_as_int(a * cw[i]));
          }
        }
      }
    }
    if (n_px == 0) continue;
    __syncthreads();  // every binned corner is filed and counted
    // the bins' starts: an exclusive scan of the counts by the first warp,
    // in place
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
        if (i < n_px) count[i] = carry + incl - v;
        carry += __shfl_sync(kFullMask, incl, 31);
      }
    }
    __syncthreads();
    // the corners sorted by pixel, over the window (read by now)
    const int n_e = *n_filed;
    for (int e = threadIdx.x; e < n_e; e += kThreads) {
      const int2 f = filed[e];
      sorted[atomicAdd(count + (f.x >> 7), 1)] = f;
    }
    __syncthreads();
    // a lane group a run of the sorted corners: w·cw times the query's g
    // row summed while the pixel stays, added to device memory when it
    // changes (a pixel whose bin two runs share gets two adds)
    const int per = (n_e + kGroups - 1) / kGroups;
    const int lo = min(group * per, n_e), hi = min(lo + per, n_e);
    if (lo < hi) {
      float acc[K * V];
#pragma unroll
      for (int e = 0; e < K * V; ++e) acc[e] = 0.f;
      int at = sorted[lo].x >> 7;
#pragma unroll 4
      for (int e = lo; e < hi; ++e) {
        const int2 f = sorted[e];
        if ((f.x >> 7) != at) {
          add_pixel<V, G, K>(dvl, acc, at, r, Wl, hd, lane_g, d);
          at = f.x >> 7;
        }
        const float wc = __int_as_float(f.y);
        const bf16* gq = gs + (f.x & 127) * d;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = (lane_g + k * G) * V;
          if (c < d) {
            float t[V];
            load_slice<V, false>(t, gq + c);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[k * V + v] = fmaf(wc, t[v], acc[k * V + v]);
          }
        }
      }
      add_pixel<V, G, K>(dvl, acc, at, r, Wl, hd, lane_g, d);
    }
  }
}

// d_value: the f32 sums rounded to nearest even, once
__global__ void round_kernel(const float* __restrict__ src,
                             bf16* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

__host__ __device__ constexpr int shared_bytes(int stage_elems, int bin_px,
                                               int G, int d, int P) {
  return (bin_px ? kMaxTileQueries * P * kCornersPerSample *
                           (int)sizeof(int2) +
                       (bin_px + 1) * (int)sizeof(int)
                 : 0) +
         region_bytes(stage_elems,
                      bin_px ? kMaxTileQueries * P * kCornersPerSample : 0) +
         round_up8(kMaxTileQueries * d) * 2 +
         kThreads / G * records_per_group(G) * kRecordBytes;
}

template <int V, int G, int K>
int run(const bf16* value, const int* levels, const int* tiles,
        const int* perm, const float* pos, const float* weight,
        const bf16* grad_out, float* d_value_acc, bf16* d_value,
        float* d_pos, float* d_weight, int B, int S, int Nq, int h, int d,
        int L, int P, int n_tiles, int stage_elems, int bin_px,
        cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long long)B * n_tiles * h);
  const int smem = shared_bytes(stage_elems, bin_px, G, d, P);
  auto kernel = msda_bwd_bf16_kernel<V, G, K>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      value, levels, tiles, perm, pos, weight, grad_out, d_value_acc, d_pos,
      d_weight, S, Nq, h, d, L, P, n_tiles, stage_elems, bin_px);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  round_kernel<<<1024, 256, 0, stream>>>(d_value_acc, d_value,
                                         (long long)B * S * h * d);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, h, d) and grad_out (B, Nq, h·d) bf16; levels, tiles, perm,
// pos, weight and stage_elems as `msda_fwd` takes them (csrc/msda.cu);
// outputs d_value (B, S, h, d) bf16, d_pos and d_weight f32 in the shapes
// of pos and weight; d_value_acc: an f32 buffer of the value's shape that
// the caller lends, zeroed here, summed into and rounded into d_value at
// the end; all contiguous. vec = 8 (16-byte slices over `lanes` = 4, 8 or
// 16 lanes a query) needs d a multiple of 8 and value, grad_out and
// d_value_acc 16-byte aligned; vec = 1 takes single elements over 32
// lanes. Launches on `stream` the memset, the kernel and the rounding;
// returns the CUDA error, or cudaErrorInvalidValue for another instance.
extern "C" int msda_bwd_bf16(const bf16* value, const int* levels,
                             const int* tiles, const int* perm,
                             const float* pos, const float* weight,
                             const bf16* grad_out, float* d_value_acc,
                             bf16* d_value, float* d_pos, float* d_weight,
                             int B, int S, int Nq, int h, int d, int L, int P,
                             int n_tiles, int stage_elems, int bin_px,
                             int vec, int lanes,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * S * h * d;
  cudaError_t err =
      cudaMemsetAsync(d_value_acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * n_tiles * h == 0 || d == 0) {
    round_kernel<<<1024, 256, 0, st>>>(d_value_acc, d_value, n);
    return (int)cudaGetLastError();
  }
#define MSDA_BWD_BF16(V, G, K)                                               \
  return run<V, G, K>(value, levels, tiles, perm, pos, weight, grad_out,     \
                      d_value_acc, d_value, d_pos, d_weight, B, S, Nq, h, d, \
                      L, P, n_tiles, stage_elems, bin_px, st)
  if (vec == 8 && lanes == 4) MSDA_BWD_BF16(8, 4, 1);
  if (vec == 8 && lanes == 8) MSDA_BWD_BF16(8, 8, 1);
  if (vec == 8 && lanes == 16) MSDA_BWD_BF16(8, 16, 1);
  if (vec == 1 && lanes == 32) MSDA_BWD_BF16(1, 32, 4);
#undef MSDA_BWD_BF16
  return (int)cudaErrorInvalidValue;
}
