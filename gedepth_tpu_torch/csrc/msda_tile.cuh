// Shared device code of the deformable-sampling kernels (msda.cu forward,
// msda_fwd_bf16.cu its bf16 instance, msda_bwd.cu backward, msda_bwd_bf16.cu
// the backward's bf16 instance): the tile plan's rows, the per-sample set-up
// that one lane does for its lane group, and the staging of a value window
// in shared memory.
//
// A block owns one tile of queries, one head and one batch entry. The plan
// gives, for each tile and level, a rectangle of the level; the block copies
// that rectangle's head slice into shared memory, pixel-major with d floats
// a pixel. A rectangle of height 0 means the level is gathered from device
// memory. The plan is a hint: every sample tests whether its corners lie
// inside the staged rectangle and goes to device memory when they do not.
// With a window hint the host plans (gedepth_tpu_torch/ops/msda.py
// `tile_plan`): a tile is a rectangle of one query grid, its rectangles what
// its queries can reach when their offsets are bounded. Without one the
// card plans from the positions (csrc/msda_plan.cu): a tile is a run of 128
// queries in the order of their keys, its rectangles around those keys.
//
// The value's element type T is float or __nv_bfloat16: a bf16 value is
// staged (by msda_bwd_bf16.cu) as bf16, half the bytes a pixel, and lifted
// to float where a corner is read; positions, weights, the records and
// every sum are f32 for both.
//
// A query's d channels lie over a group of G lanes, V elements a lane (the
// f32 kernels: V = 4, one 16-byte slice of floats each; the bf16 kernels
// msda_fwd_bf16.cu and msda_bwd_bf16.cu: V = 8, one 16-byte slice of 8
// bf16, `load_slice`, which msda_bwd_bf16.cu stages through V = 4's
// 16-byte copies and msda_fwd_bf16.cu does not stage; V = 1: single
// elements, K rounds of G). Lane j of a
// group sets up sample j of the level once (floor, bounds, corner
// coefficients and offset) and leaves it as a 32-byte record in shared
// memory; the group reads it back with two broadcast loads. The set-up is
// done once per sample, not once per channel.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace msda_tile {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kMaxTileQueries = 128;  // queries of a tile, as the host plans
constexpr int kTileHeader = 6;  // ints of a plan row before its rectangles
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRecordBytes = 32;

// samples a lane group sets up at a time: one record each in shared memory
__host__ __device__ constexpr int records_per_group(int G) {
  return G < 8 ? G : 8;
}
__host__ __device__ constexpr int round_up4(int n) { return (n + 3) / 4 * 4; }

struct Rect {
  int y_lo, x_lo, rh, rw;
};

// One sample as its lane group reads it: the four corner coefficients
// (zero for a corner outside the level), the attention weight, the offset
// in elements of corner (ya, xa) from the stage's (or the level's) origin,
// before the channel, and the steps to the right and the lower corners.
// sy >= 0: all four corners lie in the staged rectangle; sy < 0: they are
// read from device memory and the lower step is -1 - sy.
struct alignas(16) Record {
  float c00, c01, c10, c11;
  float a;
  int off, sx, sy;
};

struct Setup {
  Record rec;
  float fx, fy;
  bool in00, in01, in10, in11;  // the corner lies in the level
};

// Corner (y0 + i, x0 + j) outside the level gets coefficient 0 and is read
// at the clamped address. Bounds are tested, and the floor clamped, in float
// before any int cast, so positions far outside never reach an integer.
__device__ __forceinline__ Setup setup_sample(float x, float y, float a,
                                              int Hl, int Wl, const Rect& r,
                                              int d, int hd) {
  Setup s;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const bool x0in = x0f >= 0.f && x0f < (float)Wl;
  const bool x1in = x0f >= -1.f && x0f < (float)(Wl - 1);
  const bool y0in = y0f >= 0.f && y0f < (float)Hl;
  const bool y1in = y0f >= -1.f && y0f < (float)(Hl - 1);
  // clamped in float to one pixel outside: a sample off the level keeps an
  // address at the level's near edge, inside its query's window
  const int x0 = (int)fminf(fmaxf(x0f, -1.f), (float)Wl);
  const int y0 = (int)fminf(fmaxf(y0f, -1.f), (float)Hl);
  const int xa = min(max(x0, 0), Wl - 1), xb = min(max(x0 + 1, 0), Wl - 1);
  const int ya = min(max(y0, 0), Hl - 1), yb = min(max(y0 + 1, 0), Hl - 1);
  const bool staged = xa >= r.x_lo && xb < r.x_lo + r.rw && ya >= r.y_lo &&
                      yb < r.y_lo + r.rh;
  s.fx = fx, s.fy = fy;
  s.in00 = y0in && x0in, s.in01 = y0in && x1in;
  s.in10 = y1in && x0in, s.in11 = y1in && x1in;
  s.rec.c00 = s.in00 ? (1.f - fx) * (1.f - fy) : 0.f;
  s.rec.c01 = s.in01 ? fx * (1.f - fy) : 0.f;
  s.rec.c10 = s.in10 ? (1.f - fx) * fy : 0.f;
  s.rec.c11 = s.in11 ? fx * fy : 0.f;
  s.rec.a = a;
  if (staged) {
    s.rec.off = ((ya - r.y_lo) * r.rw + (xa - r.x_lo)) * d;
    s.rec.sx = (xb - xa) * d;
    s.rec.sy = (yb - ya) * r.rw * d;
  } else {
    s.rec.off = (ya * Wl + xa) * hd;
    s.rec.sx = (xb - xa) * hd;
    s.rec.sy = -1 - (yb - ya) * Wl * hd;
  }
  return s;
}

__device__ __forceinline__ void store_record(Record* dst, const Record& r) {
  float4* p = reinterpret_cast<float4*>(dst);
  p[0] = make_float4(r.c00, r.c01, r.c10, r.c11);
  p[1] = make_float4(r.a, __int_as_float(r.off), __int_as_float(r.sx),
                     __int_as_float(r.sy));
}

__device__ __forceinline__ Record load_record(const Record* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
  const float4 lo = p[0], hi = p[1];
  return Record{lo.x, lo.y, lo.z, lo.w, hi.x, __float_as_int(hi.y),
                __float_as_int(hi.z), __float_as_int(hi.w)};
}

// V floats from p: one 16-byte load for V = 4. Global reads go through the
// read-only path.
template <int V, bool kGlobal>
__device__ __forceinline__ void load_vec(float (&dst)[V], const float* p) {
  if constexpr (V == 4) {
    float4 t;
    if constexpr (kGlobal) {
      t = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      t = *reinterpret_cast<const float4*>(p);
    }
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = kGlobal ? __ldg(p + v) : p[v];
  }
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

// V floats to p as bf16, each rounded to nearest even once: one 16-byte
// store for V = 8
template <int V>
__device__ __forceinline__ void store_slice(bf16* p, const float (&src)[V]) {
  if constexpr (V == 8) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t =
          __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = __float2bfloat16_rn(src[v]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&src)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = src[v];
  }
}

// one element through the read-only path
__device__ __forceinline__ float ldg_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ bf16 ldg_elem(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The head slice of rectangle r of a level into `stage`, pixel-major, d
// elements a pixel; vl points at (level origin, this head). For V = 4 the
// copies are 16 bytes (4 floats or 8 bf16: d is a multiple of that). All
// threads of the block call it; the copies have landed for the calling
// thread on return, for the block after the next __syncthreads().
template <int V, typename T>
__device__ __forceinline__ void stage_window(T* stage, const T* vl,
                                             const Rect& r, int Wl, int hd,
                                             int d) {
  constexpr int E = V == 4 ? 16 / (int)sizeof(T) : 1;  // elements a copy
  const int chunks = d / E;
  const int total = r.rh * r.rw * chunks;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int px = t / chunks, c = (t - px * chunks) * E;
    const int y = px / r.rw, x = px - y * r.rw;
    const T* src = vl + ((r.y_lo + y) * Wl + r.x_lo + x) * hd + c;
    if constexpr (V == 4) {
      cp_async16(stage + px * d + c, src);
    } else {
      stage[px * d + c] = ldg_elem(src);
    }
  }
  if constexpr (V == 4) cp_async_wait_all();
}

// One tile's row of the plan. A host plan (no `perm`) has the same rows for
// every batch entry: a rectangle (y0, x0, th, tw) of the query grid that
// starts at q_start and is Wq wide. A plan made on the card
// (csrc/msda_plan.cu) has rows for each entry: the tile's queries are
// perm[q_start .. q_start + tw), th = 1.
struct Tile {
  int q_start, Wq, y0, x0, th, tw;
  const int* rects;
  const int* perm;
  // the row of block tile `bt` (batch entry b, its tile bt - b·n_tiles)
  __device__ __forceinline__ Tile(const int* tiles, const int* perm_, int bt,
                                  int b, int n_tiles, int L) {
    perm = perm_;
    const int* row = tiles + (long long)(perm ? bt : bt - b * n_tiles) *
                                 (kTileHeader + 4 * L);
    q_start = row[0], Wq = row[1], y0 = row[2], x0 = row[3];
    th = row[4], tw = row[5];
    rects = row + kTileHeader;
  }
  __device__ __forceinline__ Rect rect(int l) const {
    return Rect{rects[4 * l], rects[4 * l + 1], rects[4 * l + 2],
                rects[4 * l + 3]};
  }
  // query index of the tile's i-th query (row-major within a grid tile)
  __device__ __forceinline__ int query(int i) const {
    if (perm) return perm[q_start + i];
    const int iy = i / tw;
    return q_start + (y0 + iy) * Wq + x0 + (i - iy * tw);
  }
};

}  // namespace msda_tile
