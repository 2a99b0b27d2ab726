// The tile plan of an unhinted launch of kernels B and C, made on the card
// from the sample positions.
//
// Replaces no TPU kernel. The TPU's windowed kernels
// (gedepth_tpu/ops/pallas/msda_windowed.py) took a static plan from the
// query grid and the radius that bounds the offsets; the exact rule
// (`exact_positions`, the default sampling) has no such radius, and its
// learned cross-attention reference points put neighbouring queries
// anywhere on the level, so a plan for it can only come from the positions
// of the call. This kernel exists so that B and C can stage value windows
// in shared memory for such calls. For each batch entry (offsets differ by
// entry) it
//   1. gives each query a key (`plan_keys`): the per-axis lower median, in
//      cells of 2^shift pixels of the finest level, of its h·P samples on
//      that level (32 spread evenly over them where there are more),
//      ignoring samples with no corner inside it; a query with none gets
//      the last id. A median does not move for the few samples an offset
//      throws far away. Cells are numbered in 8x8 blocks, raster over the
//      blocks and Morton order inside one, so consecutive ids make compact
//      regions;
//   2. orders the queries by key with a counting sort that is stable, ties
//      by query index: per-chunk histograms (`plan_hist`), their prefix
//      over chunks (`plan_prefix`), and an ordered scatter (`plan_scatter`),
//      so the plan is the same in every run;
//   3. writes one tile row per 128 consecutive queries of that order
//      (`plan_rects`): the slice of the permutation, and for each level the
//      rectangle to stage, the box of the tile's keys mapped to the level
//      and grown by a margin, clipped to the level. The margin is taken
//      from where the samples fall: the least that holds all four corners
//      of kCoverPct percent of the samples of every 16th query of the tile
//      that touch the level, or the largest that keeps the rectangle within
//      `max_pixels` where that holds fewer. A level is staged wherever its
//      box fits `max_pixels` and a counted sample touches it; else its
//      height is 0.
// The sizes are fixed by the shapes (ceil(Nq / 128) tiles an entry; the
// caller allocates every buffer), so nothing here waits for the host.
//
// What bounds it on the H100: at the shapes of the main path, latency: each
// of its five kernels is a short chain of dependent steps (a query's two
// bisections, a chunk's ordered scatter by one warp, a tile's box, margins
// and counts), 2-45 µs each; the bytes it must read (32 positions a query,
// a 16th of the queries' rows) take a few µs.
// gedepth_tpu_torch/ops/msda.py `plan_plain` is its plain version, integer
// for integer.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 1024;       // queries of a histogram chunk
constexpr int kTileQueries = 128;  // queries of a tile (msda_tile.cuh)
constexpr int kHeader = 6;         // ints of a tile row before its rects
constexpr int kMaxIds = 8193;      // cell ids and the one of no cell
constexpr int kShareStride = 16;   // every 16th query of a tile counts
constexpr int kMaxLevels = 8;
constexpr int kMarginBins = 64;    // margins 0..62 counted, 63 and more
constexpr int kCountBatch = 8;     // positions a thread loads at once
constexpr int kPrefixBatch = 16;   // chunks a thread of `plan_prefix` reads
// the percent of a tile's counted samples a margin is grown to hold
// (ops/msda.py PLAN_COVER_PCT)
constexpr int kCoverPct = 97;

__device__ __forceinline__ int morton3(int y, int x) {
  int m = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    m |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1);
  return m;
}

__device__ __forceinline__ int cell_id(int cy, int cx, int n_tx) {
  return ((cy >> 3) * n_tx + (cx >> 3)) * 64 + morton3(cy & 7, cx & 7);
}

__device__ __forceinline__ void cell_of(int id, int n_tx, int& cy, int& cx) {
  const int t = id >> 6, m = id & 63;
  int y = 0, x = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x |= ((m >> (2 * i)) & 1) << i;
    y |= ((m >> (2 * i + 1)) & 1) << i;
  }
  cy = (t / n_tx) * 8 + y;
  cx = (t % n_tx) * 8 + x;
}

// the lower median of the valid lanes' values v: the least m with at least
// k + 1 values <= m, by bisection over [0, hi]
__device__ __forceinline__ int warp_median(int v, bool ok, int k, int hi) {
  int lo = 0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__popc(__ballot_sync(kFull, ok && v <= mid)) > k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// 1. a warp a query, a lane a sample: all h·P samples where they are 32 or
// fewer, else 32 spread evenly over them (lane j takes sample j·h·P / 32)
__global__ void plan_keys(const float* __restrict__ pos,
                          const int* __restrict__ levels,
                          int* __restrict__ keys, long long n_queries, int h,
                          int L, int P, int l0, int shift, int n_tx,
                          int n_ids) {
  const long long gq =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (gq >= n_queries) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int H0 = levels[3 * l0], W0 = levels[3 * l0 + 1];
  const int n = h * P;
  const int s = n > 32 ? lane * n / 32 : lane;
  bool ok = false;
  int cx = 0, cy = 0;
  if (s < n) {
    const int head = s / P, p = s - head * P;
    const float2 xy = __ldg(reinterpret_cast<const float2*>(
        pos + (gq * h * L + head * L + l0) * P * 2) + p);
    // a corner inside the level; NaN fails every test
    if (xy.x > -1.f && xy.x < (float)W0 && xy.y > -1.f && xy.y < (float)H0) {
      ok = true;
      cx = min(max((int)floorf(xy.x), 0), W0 - 1) >> shift;
      cy = min(max((int)floorf(xy.y), 0), H0 - 1) >> shift;
    }
  }
  const int valid = __popc(__ballot_sync(kFull, ok));
  int id = n_ids - 1;
  if (valid > 0) {
    const int k = (valid - 1) / 2;
    id = cell_id(warp_median(cy, ok, k, (H0 - 1) >> shift),
                 warp_median(cx, ok, k, (W0 - 1) >> shift), n_tx);
  }
  if (lane == 0) keys[gq] = id;
}

// 2a. the ids' counts in each chunk of kChunk queries of an entry
__global__ void plan_hist(const int* __restrict__ keys, int* __restrict__ hist,
                          int Nq, int n_chunks, int n_ids) {
  __shared__ int count[kMaxIds];
  const int c = blockIdx.x, b = blockIdx.y;
  for (int i = threadIdx.x; i < n_ids; i += blockDim.x) count[i] = 0;
  __syncthreads();
  const int q0 = c * kChunk, q1 = min(q0 + kChunk, Nq);
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x)
    atomicAdd(count + keys[(long long)b * Nq + q], 1);
  __syncthreads();
  int* out = hist + ((long long)b * (n_chunks + 1) + c) * n_ids;
  for (int i = threadIdx.x; i < n_ids; i += blockDim.x) out[i] = count[i];
}

// 2b. each chunk's count of an id becomes the count of that id in the
// chunks before it; row n_chunks gets the totals
__global__ void plan_prefix(int* __restrict__ hist, int n_chunks, int n_ids) {
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= n_ids) return;
  int* col = hist + (long long)blockIdx.y * (n_chunks + 1) * n_ids + id;
  int run = 0;
  // a batch of loads in flight before the stores that follow them
  for (int c0 = 0; c0 < n_chunks; c0 += kPrefixBatch) {
    int v[kPrefixBatch];
#pragma unroll
    for (int j = 0; j < kPrefixBatch; ++j)
      v[j] = c0 + j < n_chunks ? col[(long long)(c0 + j) * n_ids] : 0;
#pragma unroll
    for (int j = 0; j < kPrefixBatch; ++j) {
      if (c0 + j < n_chunks) col[(long long)(c0 + j) * n_ids] = run;
      run += v[j];
    }
  }
  col[(long long)n_chunks * n_ids] = run;
}

// 2c. each chunk's queries to their places, in query order within an id
__global__ void __launch_bounds__(1024)
plan_scatter(const int* __restrict__ keys, const int* __restrict__ hist,
             int* __restrict__ perm, int Nq, int n_chunks, int n_ids) {
  __shared__ int start[kMaxIds];
  __shared__ int warp_sum[32];
  const int c = blockIdx.x, b = blockIdx.y;
  const int* rows = hist + (long long)b * (n_chunks + 1) * n_ids;
  const int* totals = rows + (long long)n_chunks * n_ids;
  const int* before = rows + (long long)c * n_ids;
  // exclusive scan of the totals, staged in shared memory by coalesced
  // loads: a contiguous run of ids a thread
  for (int i = threadIdx.x; i < n_ids; i += blockDim.x) start[i] = totals[i];
  __syncthreads();
  const int per = (n_ids + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, n_ids);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += start[i];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (int)(blockDim.x / 32) ? warp_sum[lane] : 0;
    int w = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += up;
    }
    warp_sum[lane] = w - v;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int i = i0; i < i1; ++i) {
    const int v = start[i];
    start[i] = run;
    run += v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_ids; i += blockDim.x) start[i] += before[i];
  __syncthreads();
  if (warp != 0) return;
  // one warp places the chunk's queries 32 at a time, in order; their ids
  // are loaded first
  const int q_end = min((c + 1) * kChunk, Nq);
  int* out = perm + (long long)b * Nq;
  int ids[kChunk / 32];
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
    const int q = c * kChunk + 32 * k + lane;
    ids[k] = q < q_end ? keys[(long long)b * Nq + q] : -1 - lane;
  }
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
    const int q = c * kChunk + 32 * k + lane;
    const bool live = q < q_end;
    const int id = ids[k];
    const unsigned peers = __match_any_sync(kFull, id);
    if (live) {
      const int rank = __popc(peers & ((1u << lane) - 1u));
      out[start[id] + rank] = q;
    }
    __syncwarp();
    if (live && lane == 31 - __clz(peers)) start[id] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// level-l pixels [lo, hi] that the finest level's pixels [a, b] map to
// (centres (p + 0.5)·n_l / n_0 − 0.5, the upper end one past), clipped
__device__ __forceinline__ void map_range(int a, int b, int n0, int nl,
                                          int& lo, int& hi) {
  lo = (int)floor_div((2LL * a + 1) * nl - n0, 2LL * n0);
  hi = (int)floor_div((2LL * b + 3) * nl - n0, 2LL * n0);
  lo = max(lo, 0), hi = min(hi, nl - 1);
}

__device__ __forceinline__ long long grown_area(int ylo, int yhi, int xlo,
                                                int xhi, int m, int Hl,
                                                int Wl) {
  return (long long)(min(yhi + m, Hl - 1) - max(ylo - m, 0) + 1) *
         (min(xhi + m, Wl - 1) - max(xlo - m, 0) + 1);
}

// 3. a block a tile: its row of the plan. A thread a level maps the box of
// the tile's keys to the level and finds the largest margin that keeps it
// within max_pixels; the block then counts, for the samples of every
// kShareStride-th query (all levels at once, each query's rows read
// whole), the margin each sample needs; a thread a level takes the least
// margin that holds kCoverPct percent of the counted samples that touch
// the level (the largest that fits where none does), and stages the level
// where the box fits and a counted sample touches it.
__global__ void plan_rects(const float* __restrict__ pos,
                           const int* __restrict__ levels,
                           const int* __restrict__ keys,
                           const int* __restrict__ perm,
                           int* __restrict__ tiles, int Nq, int h, int L,
                           int P, int l0, int shift, int n_tx, int n_ids,
                           int n_tiles, int max_pixels) {
  __shared__ int box[4];                  // cy_lo, cy_hi, cx_lo, cx_hi
  __shared__ int lbox[kMaxLevels][5];     // y_lo, y_hi, x_lo, x_hi, margin
  __shared__ int need[kMaxLevels][kMarginBins];  // samples by margin
  __shared__ int touch[kMaxLevels];
  __shared__ int tq[kTileQueries];
  const int t = blockIdx.x, b = blockIdx.y;
  const int first = t * kTileQueries;
  const int cnt = min(kTileQueries, Nq - first);
  const long long base = (long long)b * Nq;
  int* row = tiles + ((long long)b * n_tiles + t) * (kHeader + 4 * L);
  if (threadIdx.x == 0) {
    box[0] = INT_MAX, box[1] = INT_MIN, box[2] = INT_MAX, box[3] = INT_MIN;
    row[0] = (int)(base + first), row[1] = -1, row[2] = 0, row[3] = 0;
    row[4] = 1, row[5] = cnt;
  }
  for (int i = threadIdx.x; i < kMaxLevels * kMarginBins; i += blockDim.x)
    need[i / kMarginBins][i % kMarginBins] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const int q = perm[base + first + i];
    tq[i] = q;
    const int id = keys[base + q];
    if (id != n_ids - 1) {
      int cy, cx;
      cell_of(id, n_tx, cy, cx);
      atomicMin(box + 0, cy), atomicMax(box + 1, cy);
      atomicMin(box + 2, cx), atomicMax(box + 3, cx);
    }
  }
  __syncthreads();
  if (threadIdx.x < L) {
    const int l = threadIdx.x;
    const int H0 = levels[3 * l0], W0 = levels[3 * l0 + 1];
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    int ylo = 0, yhi = -1, xlo = 0, xhi = -1, margin = -1;
    if (box[0] <= box[1]) {
      map_range(box[0] << shift, min(((box[1] + 1) << shift) - 1, H0 - 1),
                H0, Hl, ylo, yhi);
      map_range(box[2] << shift, min(((box[3] + 1) << shift) - 1, W0 - 1),
                W0, Wl, xlo, xhi);
      if (grown_area(ylo, yhi, xlo, xhi, 0, Hl, Wl) <= max_pixels) {
        int lo = 0, hi = max(Hl, Wl);
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (grown_area(ylo, yhi, xlo, xhi, mid, Hl, Wl) <= max_pixels) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        margin = lo;
      }
    }
    lbox[l][0] = ylo, lbox[l][1] = yhi, lbox[l][2] = xlo, lbox[l][3] = xhi;
    lbox[l][4] = margin;
    touch[l] = 0;
  }
  __syncthreads();
  const int per_query = h * L * P;  // (x, y) pairs of a query's row
  const int total = (cnt + kShareStride - 1) / kShareStride * per_query;
  for (int j0 = threadIdx.x; j0 < total; j0 += blockDim.x * kCountBatch) {
    float2 xy[kCountBatch];
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const int j = j0 + k * blockDim.x;
      xy[k] = make_float2(NAN, NAN);
      if (j < total && lbox[(j % per_query / P) % L][4] >= 0)
        xy[k] = __ldg(reinterpret_cast<const float2*>(
                          pos + (base + tq[j / per_query * kShareStride]) *
                                    per_query * 2) +
                      j % per_query);
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      const int l = ((j0 + k * blockDim.x) % per_query / P) % L;
      const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
      const float x0f = floorf(xy[k].x), y0f = floorf(xy[k].y);
      // NaN (not counted) fails every test
      if (!(x0f >= -1.f && x0f < (float)Wl && y0f >= -1.f &&
            y0f < (float)Hl))
        continue;
      // the corners as kernels B and C clamp them (msda_tile.cuh), and the
      // margin around the level's box that holds all four
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int xa = max(x0, 0), xb = min(x0 + 1, Wl - 1);
      const int ya = max(y0, 0), yb = min(y0 + 1, Hl - 1);
      const int m = max(max(max(lbox[l][0] - ya, yb - lbox[l][1]),
                            max(lbox[l][2] - xa, xb - lbox[l][3])), 0);
      atomicAdd(touch + l, 1);
      atomicAdd(&need[l][min(m, kMarginBins - 1)], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < L) {
    const int l = threadIdx.x;
    const int Hl = levels[3 * l], Wl = levels[3 * l + 1];
    const int fits = lbox[l][4], n = touch[l];
    // the least margin that holds kCoverPct percent
    int margin = fits, held = 0;
    for (int m = 0; m <= min(fits, kMarginBins - 2); ++m) {
      held += need[l][m];
      if (100LL * held >= (long long)kCoverPct * n) {
        margin = m;
        break;
      }
    }
    int* r = row + kHeader + 4 * l;
    if (fits >= 0 && n > 0) {
      r[0] = max(lbox[l][0] - margin, 0), r[1] = max(lbox[l][2] - margin, 0);
      r[2] = min(lbox[l][1] + margin, Hl - 1) - r[0] + 1;
      r[3] = min(lbox[l][3] + margin, Wl - 1) - r[1] + 1;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0;
    }
  }
}

}  // namespace

// pos (B, Nq, h, L, P, 2) f32, contiguous; levels (L, 3) int32 rows (H, W,
// start). Outputs and scratch, int32, allocated by the caller: keys (B, Nq);
// hist (B, n_chunks + 1, n_ids) with n_chunks = ceil(Nq / 1024); perm (B,
// Nq), each entry's queries in plan order; tiles (B·ceil(Nq / 128), 6 +
// 4·L), rows of `msda_tile::Tile` whose first int is an offset into perm.
// l0: the finest level; shift: log2 of a cell's side in its pixels; n_tx:
// 8x8 blocks of cells in a row; n_ids: 64 a block, plus one; L <= 8,
// n_ids <= 8193; max_pixels: of a staged rectangle. Launches five kernels on `stream`; returns the
// CUDA error.
extern "C" int msda_plan(const float* pos, const int* levels, int* keys,
                         int* hist, int* perm, int* tiles, int B, int Nq,
                         int h, int L, int P, int l0, int shift, int n_tx,
                         int n_ids, int max_pixels, void* stream) {
  if ((long long)B * Nq == 0) return (int)cudaGetLastError();
  if (L > kMaxLevels || n_ids > kMaxIds || n_ids < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_queries = (long long)B * Nq;
  const int n_chunks = (Nq + kChunk - 1) / kChunk;
  const int n_tiles = (Nq + kTileQueries - 1) / kTileQueries;
  plan_keys<<<(unsigned)((n_queries + 7) / 8), 256, 0, st>>>(
      pos, levels, keys, n_queries, h, L, P, l0, shift, n_tx, n_ids);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_hist<<<dim3(n_chunks, B), 1024, 0, st>>>(keys, hist, Nq, n_chunks,
                                                 n_ids);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_prefix<<<dim3((n_ids + 255) / 256, B), 256, 0, st>>>(hist, n_chunks,
                                                            n_ids);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_scatter<<<dim3(n_chunks, B), 1024, 0, st>>>(keys, hist, perm, Nq,
                                                    n_chunks, n_ids);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_rects<<<dim3(n_tiles, B), 256, 0, st>>>(
      pos, levels, keys, perm, tiles, Nq, h, L, P, l0, shift, n_tx, n_ids,
      n_tiles, max_pixels);
  return (int)cudaGetLastError();
}
