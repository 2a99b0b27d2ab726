"""Multi-scale deformable sampling and the windowed position rule.

`msda(value, spatial_shapes, pos, weights)` samples every level of a
flattened value with zero-padded bilinear interpolation at positions given
in level pixels and sums the weighted samples:

  value    (B, ΣHW, heads, d)   the value projection output, levels stacked
  pos      (B, Nq, heads, L, P, 2)  (x, y) level pixels, x = loc·W − 0.5
  weights  (B, Nq, heads, L, P)
  returns  (B, Nq, heads·d)

The wrapper calls the dispatcher op `msda_op` (`gedepth_torch::msda`),
whose backward is the op `msda_backward_op` (`gedepth_torch::msda_backward`):
on a CUDA tensor the hand-written forward kernel of `csrc/msda.cu` (B) and,
under autograd, the backward kernel of `csrc/msda_bwd.cu` (C), which emits
d_value, d_pos and d_weights; on a CPU tensor the plain per-level gather
(`msda_plain`) and its backward written out (`msda_backward_plain`, kernel
C's plain twin, equal to autograd through `msda_plain` to the bit).

The value is f32 or bf16, and each kernel has an instance for either. pos
and weights are f32 at the kernels' boundary whatever the value: a bf16
position on a 304-pixel level has a quarter-pixel grid, so a bf16 model
forms them in f32 from its bf16 projections (as the JAX package's kernel
path lifts them). With a bf16 value the output is bf16: the sums are f32
and rounded once, in the kernels and in the plain version alike; kernel C
takes grad_out in bf16 and returns d_value in bf16 (summed in f32, rounded
once), d_pos and d_weights in f32. A bf16 window takes half the shared
memory, so the tile plan of a bf16 value stages more.

Both kernels walk a tile plan (`tile_plan`): a block owns a rectangle of
one query grid and one head and, level by level, stages in shared memory
the value window its queries can reach. The plan needs the query grids
and the radius that bounds the offsets (`query_shapes`, `window_radius`);
without them every level is gathered from device memory. The plan only
makes the kernels fast: a sample that leaves its staged window is read
from (and, in C, added to) device memory, so any positions are sampled
correctly.

The sampling modes of `gedepth_tpu.ops.msda` differ only in how positions
are formed; the rules are plain functions on tensors, differentiated by
autograd upstream of the kernels:

  * `exact_positions` ('bilinear'): loc = ref + off / (W_l, H_l), then
    x = loc·W_l − 0.5, in that f32 order;
  * `nearest_positions` ('nearest'): floor(loc·size) as an integer-valued
    float, so the bilinear rule reads one corner with weight 1; the
    floor's gradient is zero;
  * `windowed_positions` ('windowed'): each query's anchor on the level (its
    grid centre, split into an integer anchor and a residual from the
    float64 table of `gedepth_tpu.ops.msda._axis_anchor_residual`) plus the
    bounded offset R·tanh(off/R);
  * `compat_positions` ('windowed_compat'): the same anchor plus the exact
    rule's displacement from the grid centre (`compat_delta_px`) clamped to
    ±R level pixels.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math

import numpy as np
import torch

from gedepth_tpu_torch.ops import _lib

# queries per step of the plain gather (bounds its temporaries)
PLAIN_QUERY_CHUNK = 4096
# channels per head the kernels take: a query's channels lie over at most
# 32 lanes of 4
MAX_HEAD_DIM = 128
# threads of a block of kernels B and C, and the most queries of a tile
# (csrc/msda_tile.cuh)
TILE_THREADS = 512
MAX_TILE_QUERIES = 128
# shared memory of an SM; two blocks share it, each with 1 KB reserved
SM_SHARED_BYTES = 232448
BLOCK_SHARED_BYTES = SM_SHARED_BYTES // 2 - 1024
RECORD_BYTES = 32


def _round_up4(n: int) -> int:
    return -(-n // 4) * 4


def shared_bytes(stage_elems: int, head_dim: int, lanes: int,
                 itemsize: int = 4) -> int:
    """Dynamic shared memory of a block of kernel B: the staged value
    window (`stage_elems` elements of `itemsize` bytes), the tile's running
    sums (d floats a query), and a 32-byte record for each of the 8 (or
    `lanes`, if fewer) samples a lane group sets up at a time."""
    records = TILE_THREADS // lanes * min(lanes, 8) * RECORD_BYTES
    return (itemsize * stage_elems
            + 4 * _round_up4(MAX_TILE_QUERIES * head_dim) + records)


def shared_bytes_backward(stage_elems: int, head_dim: int, lanes: int,
                          points: int) -> int:
    """Dynamic shared memory of the larger block of kernel C, the d_value
    kernel: the tile's grad_out rows, the groups' records, the list of
    (query, coefficient) pairs of every corner of the tile's samples on one
    level, and a count and a bin start per pixel of the staged window. (Its
    d_pos kernel takes the staged window plus records and dots: less than
    kernel B.)"""
    records = TILE_THREADS // lanes * min(lanes, 8) * RECORD_BYTES
    corners = MAX_TILE_QUERIES * points * 4 * 8 if stage_elems else 0
    return (4 * _round_up4(MAX_TILE_QUERIES * head_dim) + records + corners
            + 4 * (2 * (stage_elems // head_dim) + 1))


def stage_budget(head_dim: int, lanes: int) -> int:
    """Bytes a staged window may take so that two blocks share an SM."""
    return max(BLOCK_SHARED_BYTES - shared_bytes(0, head_dim, lanes), 0)


# query-tile shapes tried per query grid, largest first
TILE_CANDIDATES = ((8, 16), (8, 8), (4, 8))
# ints of a tile's row before its per-level rectangles
TILE_HEADER = 6


def axis_anchor_residual(nq: int, nv: int):
    """Anchor (int) and residual (float32) of each query centre on a value
    axis: centre = (i + 0.5)·nv/nq − 0.5 = anchor + residual."""
    q = (np.arange(nq, dtype=np.float64) + 0.5) * (nv / nq) - 0.5
    a = np.floor(q).astype(np.int64)
    return a, (q - a).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _anchor_tables(query_shapes, spatial_shapes, device):
    """(ΣNq, L, 2) f32 anchors (exact integers) and residuals, (x, y)."""
    anchors, residuals = [], []
    for (Hq, Wq) in query_shapes:
        anc = np.zeros((Hq, Wq, len(spatial_shapes), 2), np.float32)
        res = np.zeros_like(anc)
        for l, (Hv, Wv) in enumerate(spatial_shapes):
            ay, ry = axis_anchor_residual(Hq, Hv)
            ax, rx = axis_anchor_residual(Wq, Wv)
            anc[:, :, l, 0] = ax[None, :]
            anc[:, :, l, 1] = ay[:, None]
            res[:, :, l, 0] = rx[None, :]
            res[:, :, l, 1] = ry[:, None]
        anchors.append(anc.reshape(Hq * Wq, -1, 2))
        residuals.append(res.reshape(Hq * Wq, -1, 2))
    to = functools.partial(torch.as_tensor, device=device)
    # normal tensors even under inference_mode (see `_level_table`)
    with torch.inference_mode(False):
        return (to(np.concatenate(anchors)), to(np.concatenate(residuals)))


def anchored_positions(displacement, query_shapes, spatial_shapes):
    """anchor + (residual + displacement): level-pixel positions of samples
    displaced (B, Nq, heads, L, P, 2) level pixels from their queries' grid
    centres; the queries are the row-major grids `query_shapes`,
    concatenated. The residual sum is taken first, in f32, as the JAX
    package forms it."""
    anc, res = _anchor_tables(tuple(map(tuple, query_shapes)),
                              tuple(map(tuple, spatial_shapes)),
                              displacement.device)
    return ((res[None, :, None, :, None, :] + displacement)
            + anc[None, :, None, :, None, :])


def windowed_positions(offsets, query_shapes, spatial_shapes, radius):
    """Level-pixel sample positions of the windowed rule: the query's grid
    centre plus R·tanh(off/R). offsets: (B, Nq, heads, L, P, 2) raw offsets
    (x, y)."""
    R = float(radius)
    return anchored_positions(R * torch.tanh(offsets / R), query_shapes,
                              spatial_shapes)


def grid_centers(query_shapes) -> np.ndarray:
    """Normalised (x, y) centres of the row-major grids `query_shapes`,
    concatenated: (ΣHW, 2) f32, (i + 0.5) / n formed in f32."""
    pts = []
    for (H_, W_) in query_shapes:
        ys = (np.arange(H_, dtype=np.float32) + 0.5) / H_
        xs = (np.arange(W_, dtype=np.float32) + 0.5) / W_
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
    return np.concatenate(pts, axis=0)


@functools.lru_cache(maxsize=16)
def _centers(query_shapes, device):
    # a normal tensor even under inference_mode (see `_level_table`)
    with torch.inference_mode(False):
        return torch.as_tensor(grid_centers(query_shapes), device=device)


@functools.lru_cache(maxsize=16)
def _normalizer(spatial_shapes, device):
    """(L, 2) f32 (W_l, H_l), the (x, y) order of the locations."""
    norm = np.array([[W_, H_] for (H_, W_) in spatial_shapes], np.float32)
    with torch.inference_mode(False):
        return torch.as_tensor(norm, device=device)


def center_reference_points(spatial_shapes, device=None):
    """Reference points of a self-attention whose queries are the levels'
    own tokens: every token's normalised grid centre, the same on each
    level: (ΣHW, L, 2), (x, y)."""
    shapes = tuple(map(tuple, spatial_shapes))
    centers = _centers(shapes, torch.device(device or "cpu"))
    return centers[:, None, :].expand(-1, len(shapes), -1)


def _broadcast_reference(reference_points):
    """(Nq, L, 2) or (B', Nq, L, 2) -> (B', Nq, 1, L, 1, 2)."""
    if reference_points.dim() == 3:
        reference_points = reference_points[None]
    return reference_points[:, :, None, :, None, :]


def _locations(reference_points, offsets, spatial_shapes):
    """Normalised sample locations ref + off / (W_l, H_l), and (W_l, H_l)."""
    norm = _normalizer(tuple(map(tuple, spatial_shapes)), offsets.device)
    norm = norm[None, None, None, :, None, :]
    return _broadcast_reference(reference_points) + offsets / norm, norm


def exact_positions(reference_points, offsets, spatial_shapes):
    """Level-pixel positions of the exact (mmcv) rule: loc = ref + off /
    (W_l, H_l), x = loc·W_l − 0.5. reference_points: (Nq, L, 2) or
    (B, Nq, L, 2) normalised (x, y); offsets (B, Nq, heads, L, P, 2) in
    level pixels."""
    locs, norm = _locations(reference_points, offsets, spatial_shapes)
    return locs * norm - 0.5


def nearest_positions(reference_points, offsets, spatial_shapes):
    """Positions of the nearest rule: the pixel floor(loc·size), zero
    outside the level, as an integer-valued float (a bilinear sample there
    is that one pixel). The floor's gradient is zero, so the offsets and
    the reference points get zero gradients, as in the JAX package."""
    locs, norm = _locations(reference_points, offsets, spatial_shapes)
    return torch.floor(locs * norm)


def compat_delta_px(reference_points, offsets, query_shapes, spatial_shapes):
    """Displacement, in level pixels, of each sample of the exact rule from
    its query's own grid centre: (ref − centre)·(W_l, H_l) + off. Unclamped
    it reproduces the exact positions; 'windowed_compat' clamps it to ±R,
    so the share of |delta| > R says how much a set of weights loses.
    Shapes as `exact_positions`; returns (B, Nq, heads, L, P, 2)."""
    centers = _centers(tuple(map(tuple, query_shapes)), offsets.device)
    norm = _normalizer(tuple(map(tuple, spatial_shapes)), offsets.device)
    delta_norm = (_broadcast_reference(reference_points)
                  - centers[None, :, None, None, None, :])
    return delta_norm * norm[None, None, None, :, None, :] + offsets


def compat_positions(reference_points, offsets, query_shapes, spatial_shapes,
                     radius):
    """Level-pixel positions of the compat rule, and the displacement before
    the clamp: anchor + (residual + clip(delta, ±R))."""
    delta = compat_delta_px(reference_points, offsets, query_shapes,
                            spatial_shapes)
    R = float(radius)
    return (anchored_positions(delta.clamp(-R, R), query_shapes,
                               spatial_shapes), delta)


def compat_clamp_mass(delta, weights, radius):
    """Attention mass that the compat clamp moved: Σ weights·any(|delta| >
    R) / (B·Nq·heads), a 0-dim tensor on the inputs' device."""
    clamped = (delta.abs() > float(radius)).any(-1).to(weights.dtype)
    B, Nq, h = weights.shape[:3]
    return (weights * clamped).sum() / (B * Nq * h)


def channel_lanes(head_dim: int, aligned: bool = True, itemsize: int = 4):
    """(elements per lane, lanes per query) of the kernel instance that
    serves a head width: slices of 4 elements over the smallest of 4, 8, 16
    or 32 lanes that holds the head, when the head is whole 16-byte units
    (a multiple of 4 floats or 8 bf16: a window is staged in 16-byte
    copies); else (or when the tensors are not 16-byte aligned) single
    elements over 32 lanes, four rounds at most."""
    if head_dim % (16 // itemsize) == 0 and aligned:
        return 4, next(g for g in (4, 8, 16, 32) if 4 * g >= head_dim)
    return 1, 32


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Query tiles of one launch. `rows` is (tiles, TILE_HEADER + 4·L)
    int32: the tile's grid (first query, grid width), its rectangle of that
    grid (y0, x0, height, width), then for each level the staged value
    rectangle (y_lo, x_lo, height, width), height 0 where the level is
    gathered from device memory."""
    rows: np.ndarray
    stage_elems: int         # elements of the largest staged rectangle


def _grid_rows(q_start, grid, tile, spatial_shapes, margin, max_pixels):
    """Rows of one query grid cut into `tile`s, and how many (query, level)
    pairs they stage. A level's rectangle covers the anchors of the tile's
    queries ± margin, clipped to the level."""
    (Hq, Wq), (th, tw) = grid, tile
    rows, staged = [], 0
    anchors = [(axis_anchor_residual(Hq, Hl)[0],
                axis_anchor_residual(Wq, Wl)[0])
               for (Hl, Wl) in spatial_shapes]
    for y0 in range(0, Hq, th):
        for x0 in range(0, Wq, tw):
            h_, w_ = min(th, Hq - y0), min(tw, Wq - x0)
            row = [q_start, Wq, y0, x0, h_, w_]
            for (ay, ax), (Hl, Wl) in zip(anchors, spatial_shapes):
                rect = (0, 0, 0, 0)
                if margin is not None:
                    y_lo = max(int(ay[y0]) - margin, 0)
                    y_hi = min(int(ay[y0 + h_ - 1]) + margin, Hl - 1)
                    x_lo = max(int(ax[x0]) - margin, 0)
                    x_hi = min(int(ax[x0 + w_ - 1]) + margin, Wl - 1)
                    rh, rw = y_hi - y_lo + 1, x_hi - x_lo + 1
                    if 0 < rh * rw <= max_pixels:
                        rect = (y_lo, x_lo, rh, rw)
                        staged += h_ * w_
                row.extend(rect)
            rows.append(row)
    return rows, staged


@functools.lru_cache(maxsize=64)
def tile_plan(query_shapes, spatial_shapes, radius, head_dim, stage_bytes,
              itemsize=4):
    """The tile plan of a launch: `query_shapes` row-major query grids,
    concatenated, sampling `spatial_shapes` with offsets bounded by
    `radius` level pixels around each query's anchor (None: unbounded,
    nothing is staged and the queries are one row). Per grid, the tile
    shape that stages the most (query, level) pairs within `stage_bytes`,
    the larger shape on a tie. `itemsize`: bytes of a value element (4 for
    f32, 2 for bf16)."""
    max_pixels = stage_bytes // (itemsize * head_dim)
    if radius is None:
        margin, candidates = None, ((1, MAX_TILE_QUERIES),)
    else:
        # floor(pos) lies within ceil(R) of the anchor, its far corner
        # one further
        margin = int(math.ceil(radius)) + 1
        candidates = TILE_CANDIDATES
    rows, q_start = [], 0
    for grid in query_shapes:
        best = None
        for tile in candidates:
            got, staged = _grid_rows(q_start, grid, tile, spatial_shapes,
                                     margin, max_pixels)
            if best is None or staged > best[1]:
                best = (got, staged)
        rows.extend(best[0])
        q_start += grid[0] * grid[1]
    rows = np.asarray(rows, np.int32).reshape(
        -1, TILE_HEADER + 4 * len(spatial_shapes))
    rects = rows[:, TILE_HEADER:].reshape(len(rows), -1, 4)
    stage_pixels = int((rects[:, :, 2] * rects[:, :, 3]).max(initial=0))
    # whole 16-byte units: the kernels lay their records after the stage
    unit = 16 // itemsize
    stage_elems = -(-stage_pixels * head_dim // unit) * unit
    return TilePlan(rows, stage_elems)


@functools.lru_cache(maxsize=64)
def _tile_table(query_shapes, spatial_shapes, radius, head_dim, stage_bytes,
                itemsize, device):
    plan = tile_plan(query_shapes, spatial_shapes, radius, head_dim,
                     stage_bytes, itemsize)
    # a normal tensor even under inference_mode (see `_level_table`)
    with torch.inference_mode(False):
        return torch.as_tensor(plan.rows, device=device), plan


def msda_plain(value, spatial_shapes, pos, weights):
    """Plain PyTorch version: four corner gathers per level, chunked over
    queries. A bf16 value is lifted to f32 and the result rounded to bf16
    once, as the bf16 kernel computes; pos and weights of any float dtype
    are taken as f32."""
    if value.dtype == torch.bfloat16:
        return msda_plain(value.float(), spatial_shapes, pos.float(),
                          weights.float()).to(value.dtype)
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    table = value.permute(0, 2, 1, 3).reshape(B * h, S, d)
    out = value.new_empty(B, Nq, h, d)
    for q0 in range(0, Nq, PLAIN_QUERY_CHUNK):
        p = pos[:, q0:q0 + PLAIN_QUERY_CHUNK]
        w = weights[:, q0:q0 + PLAIN_QUERY_CHUNK]
        n = p.shape[1]
        acc = value.new_zeros(B * h, n, d)
        start = 0
        for l, (Hl, Wl) in enumerate(spatial_shapes):
            x, y = p[:, :, :, l, :, 0], p[:, :, :, l, :, 1]   # (B, n, h, P)
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = x - x0, y - y0
            for dx, dy, cw in ((0, 0, (1 - fx) * (1 - fy)),
                               (1, 0, fx * (1 - fy)),
                               (0, 1, (1 - fx) * fy),
                               (1, 1, fx * fy)):
                xi, yi = x0 + dx, y0 + dy
                inb = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
                idx = (start + yi.clamp(0, Hl - 1) * Wl
                       + xi.clamp(0, Wl - 1)).long()
                idx = idx.permute(0, 2, 1, 3).reshape(B * h, n * P)
                g = torch.gather(table, 1, idx[..., None].expand(-1, -1, d))
                cwt = (cw * inb.to(cw.dtype) * w[:, :, :, l])
                cwt = cwt.permute(0, 2, 1, 3).reshape(B * h, n * P, 1)
                acc += (g * cwt).view(B * h, n, P, d).sum(2)
            start += Hl * Wl
        out[:, q0:q0 + n] = acc.view(B, h, n, d).permute(0, 2, 1, 3)
    return out.reshape(B, Nq, h * d)


@functools.lru_cache(maxsize=16)
def _level_table(spatial_shapes, device):
    rows, start = [], 0
    for (H_, W_) in spatial_shapes:
        rows.append((H_, W_, start))
        start += H_ * W_
    # a normal tensor even when first built under inference_mode: the cache
    # outlives the call, and autograd refuses inference tensors
    with torch.inference_mode(False):
        return torch.tensor(rows, dtype=torch.int32, device=device)


def _check(value, spatial_shapes, pos, weights):
    B, S, h, d = value.shape
    L = len(spatial_shapes)
    if sum(H_ * W_ for (H_, W_) in spatial_shapes) != S:
        raise ValueError(f"levels {spatial_shapes} do not add up to {S}")
    if pos.dim() != 6 or pos.shape[0] != B or pos.shape[2] != h \
            or pos.shape[3] != L or pos.shape[5] != 2:
        raise ValueError(f"pos shape {tuple(pos.shape)} does not match "
                         f"value {tuple(value.shape)} over {L} levels")
    if tuple(weights.shape) != tuple(pos.shape[:5]):
        raise ValueError(f"weights shape {tuple(weights.shape)} != "
                         f"{tuple(pos.shape[:5])}")
    for t in (pos, weights):
        if t.device != value.device:
            raise ValueError("msda: all inputs on one device")


def _normalise_window(query_shapes, window_radius, Nq):
    """(query_shapes, radius) as hashable plan keys; ((1, Nq),), None when
    the caller bounds nothing."""
    if (query_shapes is None) != (window_radius is None):
        raise ValueError("msda: give query_shapes and window_radius "
                         "together, or neither")
    if window_radius is None:
        return ((1, Nq),), None
    query_shapes = tuple((int(H_), int(W_)) for (H_, W_) in query_shapes)
    if sum(H_ * W_ for (H_, W_) in query_shapes) != Nq:
        raise ValueError(f"query grids {query_shapes} do not add up to "
                         f"{Nq} queries")
    radius = float(window_radius)
    if not (math.isfinite(radius) and radius > 0):
        raise ValueError(f"window_radius must be positive, got {radius}")
    return query_shapes, radius


VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_inputs(value, spatial_shapes, pos, weights, grad_out=None):
    """What kernels B and C do not take raises here: nothing falls back to
    the plain version on a CUDA tensor."""
    if value.dtype not in VALUE_DTYPES:
        raise TypeError(f"msda kernels take an f32 or bf16 value, got "
                        f"{value.dtype}")
    for name, t, dtype in (("value", value, value.dtype),
                           ("pos", pos, torch.float32),
                           ("weights", weights, torch.float32),
                           ("grad_out", grad_out, value.dtype)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"msda: no kernel for {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"msda kernel with a {value.dtype} value takes "
                            f"{name} in {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("msda kernel needs contiguous inputs")
    h, d = value.shape[2:]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"msda kernels take 1 <= d <= {MAX_HEAD_DIM}, "
                         f"got {d}")
    if max(H_ * W_ for (H_, W_) in spatial_shapes) * h * d >= 2 ** 31:
        raise ValueError("msda kernels index a level with 32 bits: "
                         f"{spatial_shapes} x {h} x {d} is too large")
    if pos.data_ptr() % 8:
        raise ValueError("msda kernels read positions as (x, y) pairs: "
                         "pos must be 8-byte aligned")


def _plan_args(value, spatial_shapes, window, *tensors):
    """The kernel instance and plan of a launch: (levels, tile table, tile
    count, stage elements, elements per lane, lanes per query)."""
    d, itemsize = value.shape[3], value.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (value, *tensors))
    vec, lanes = channel_lanes(d, aligned, itemsize)
    query_shapes, radius = window
    table, plan = _tile_table(query_shapes, spatial_shapes, radius, d,
                              stage_budget(d, lanes), itemsize, value.device)
    levels = _level_table(spatial_shapes, value.device)
    return (levels.data_ptr(), table.data_ptr(), len(plan.rows),
            plan.stage_elems, vec, lanes)


def _entry(name, value):
    return name + "_bf16" if value.dtype == torch.bfloat16 else name


def _launch_forward(value, spatial_shapes, pos, weights, window):
    """Kernel B on CUDA tensors already checked."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    out = value.new_empty(B, Nq, h * d)
    levels, tiles, n_tiles, stage_elems, vec, lanes = _plan_args(
        value, spatial_shapes, window, out)
    _lib.call(_entry("msda_fwd", value), value.data_ptr(), levels, tiles,
              pos.data_ptr(), weights.data_ptr(), out.data_ptr(), B, S, Nq, h,
              d, L, P, n_tiles, stage_elems, vec, lanes)
    msda.launches += 1
    msda.launches_by_queries[Nq] += 1
    msda.launches_by_dtype[value.dtype] += 1
    return out


def _launch_backward(value, spatial_shapes, pos, weights, grad_out, window):
    """Kernel C on CUDA tensors already checked."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    d_value = torch.empty_like(value)
    # the f32 sums (zeroed by the C entry point): d_value itself when f32
    acc = (d_value if value.dtype == torch.float32
           else torch.empty_like(value, dtype=torch.float32))
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)
    plan = _plan_args(value, spatial_shapes, window, grad_out, d_value, acc)
    if shared_bytes_backward(plan[3], d, plan[5], P) > SM_SHARED_BYTES - 1024:
        # so many points that a tile's corner list outgrows an SM: no bins
        plan = _plan_args(value, spatial_shapes, (((1, Nq),), None),
                          grad_out, d_value, acc)
    levels, tiles, n_tiles, stage_elems, vec, lanes = plan
    _lib.call(_entry("msda_bwd", value), value.data_ptr(), levels, tiles,
              pos.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
              acc.data_ptr(), d_value.data_ptr(), d_pos.data_ptr(),
              d_weights.data_ptr(), B, S, Nq, h, d, L, P, n_tiles,
              stage_elems, vec, lanes)
    msda_backward.launches += 1
    msda_backward.launches_by_queries[Nq] += 1
    msda_backward.launches_by_dtype[value.dtype] += 1
    return d_value, d_pos, d_weights


# the plain backward's corners in the order autograd through `msda_plain`
# adds their gradients (the last one formed first): (dx, dy)
_CORNERS_BACKWARD = ((1, 1), (0, 1), (1, 0), (0, 0))


def msda_backward_plain(value, spatial_shapes, pos, weights, grad_out):
    """Plain twin of kernel C: (d_value, d_pos, d_weights) of `msda_plain`
    for the cotangent grad_out, written out in tensor ops, one query chunk
    at a time. It forms every product and sum that autograd through
    `msda_plain` forms, in the same order (chunks, levels and corners from
    the last, each corner's d_value scattered into zeros and then added), so
    the two agree to the bit; it runs inside the dispatcher op, where
    autograd is not available, and never holds more than one chunk's
    corners (autograd through the whole `msda_plain` would keep every
    chunk's gathered corners alive at once, ~34 GB at the train crop's
    cross-attention)."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    if value.dtype == torch.bfloat16:
        # as kernel C: f32 sums of the lifted inputs, d_value rounded once
        d_value, d_pos, d_weights = msda_backward_plain(
            value.float(), spatial_shapes, pos, weights, grad_out.float())
        return d_value.to(value.dtype), d_pos, d_weights
    pos, weights = pos.float(), weights.float()
    B, S, h, d = value.shape
    Nq, P = pos.shape[1], pos.shape[4]
    table = value.permute(0, 2, 1, 3).reshape(B * h, S, d)
    grad_out = grad_out.view(B, Nq, h, d)
    starts = np.cumsum([0] + [H_ * W_ for (H_, W_) in spatial_shapes])
    d_table = None
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)

    def heads_first(t):         # (B, n, h, P) -> (B·h, n·P, 1)
        return t.permute(0, 2, 1, 3).reshape(B * h, -1, 1)

    for q0 in reversed(range(0, Nq, PLAIN_QUERY_CHUNK)):
        p = pos[:, q0:q0 + PLAIN_QUERY_CHUNK]
        w = weights[:, q0:q0 + PLAIN_QUERY_CHUNK]
        n = p.shape[1]
        go = grad_out[:, q0:q0 + n].permute(0, 2, 1, 3).reshape(B * h, n, d)
        # the sum over points, broadcast back: (B·h, n·P, d)
        go = go[:, :, None].expand(B * h, n, P, d).reshape(B * h, n * P, d)
        for l in reversed(range(len(spatial_shapes))):
            Hl, Wl = spatial_shapes[l]
            x, y = p[:, :, :, l, :, 0], p[:, :, :, l, :, 1]   # (B, n, h, P)
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = x - x0, y - y0
            wl = w[:, :, :, l]
            g_fx, g_fy, g_w = [], [], []
            for dx, dy in _CORNERS_BACKWARD:
                xi, yi = x0 + dx, y0 + dy
                inb = ((xi >= 0) & (xi < Wl) & (yi >= 0)
                       & (yi < Hl)).to(fx.dtype)
                idx = (int(starts[l]) + yi.clamp(0, Hl - 1) * Wl
                       + xi.clamp(0, Wl - 1)).long()
                idx = idx.permute(0, 2, 1, 3).reshape(B * h, n * P, 1)
                idx = idx.expand(-1, -1, d)
                ax = fx if dx else 1 - fx          # the corner's weight
                ay = fy if dy else 1 - fy          # cw = ax·ay
                cw_in = ax * ay * inb
                corner = torch.gather(table, 1, idx)
                # d(Σ_d go·corner·cwt)/d cwt, back to (B, n, h, P)
                dot = (go * corner).sum(-1, keepdim=True)
                dot = dot.view(B, h, n, P).permute(0, 2, 1, 3)
                d_cw = dot * wl * inb
                g_w.append(dot * cw_in)
                g_x, g_y = d_cw * ay, d_cw * ax
                g_fx.append(g_x if dx else -g_x)
                g_fy.append(g_y if dy else -g_y)
                part = table.new_zeros(B * h, S, d).scatter_add_(
                    1, idx, go * heads_first(cw_in * wl))
                d_table = part if d_table is None else d_table + part
            for g_list, out in ((g_fx, d_pos[:, q0:q0 + n, :, l, :, 0]),
                                (g_fy, d_pos[:, q0:q0 + n, :, l, :, 1]),
                                (g_w, d_weights[:, q0:q0 + n, :, l])):
                out.copy_(((g_list[0] + g_list[1]) + g_list[2]) + g_list[3])
    d_value = d_table.view(B, h, S, d).permute(0, 2, 1, 3).contiguous()
    return d_value, d_pos, d_weights


def _pairs(flat):
    """[H0, W0, H1, W1, ...] -> ((H0, W0), (H1, W1), ...)."""
    return tuple(zip(flat[::2], flat[1::2]))


def _flat(pairs):
    return [int(v) for pair in pairs for v in pair]


def _window(query_shapes, window_radius, Nq):
    """The (query grids, radius) plan key of an op's flat arguments."""
    if window_radius is None:
        return ((1, Nq),), None
    return _pairs(query_shapes), float(window_radius)


def _msda_cpu(value, spatial_shapes, pos, weights, query_shapes,
              window_radius):
    return msda_plain(value, _pairs(spatial_shapes), pos, weights)


def _msda_cuda(value, spatial_shapes, pos, weights, query_shapes,
               window_radius):
    spatial_shapes = _pairs(spatial_shapes)
    _check_kernel_inputs(value, spatial_shapes, pos, weights)
    return _launch_forward(value, spatial_shapes, pos, weights,
                           _window(query_shapes, window_radius, pos.shape[1]))


def _msda_fake(value, spatial_shapes, pos, weights, query_shapes,
               window_radius):
    B, _, h, d = value.shape
    return value.new_empty(B, pos.shape[1], h * d)


def _msda_backward_cpu(value, spatial_shapes, pos, weights, grad_out,
                       query_shapes, window_radius):
    return msda_backward_plain(value, _pairs(spatial_shapes), pos, weights,
                               grad_out)


def _msda_backward_cuda(value, spatial_shapes, pos, weights, grad_out,
                        query_shapes, window_radius):
    spatial_shapes = _pairs(spatial_shapes)
    _check_kernel_inputs(value, spatial_shapes, pos, weights, grad_out)
    return _launch_backward(
        value, spatial_shapes, pos, weights, grad_out,
        _window(query_shapes, window_radius, pos.shape[1]))


def _msda_backward_fake(value, spatial_shapes, pos, weights, grad_out,
                        query_shapes, window_radius):
    return (value.new_empty(value.shape), pos.new_empty(pos.shape),
            weights.new_empty(weights.shape))


def _setup_context(ctx, inputs, output):
    value, spatial_shapes, pos, weights, query_shapes, window_radius = inputs
    ctx.static = (spatial_shapes, query_shapes, window_radius)
    ctx.save_for_backward(value, pos, weights)


def _backward(ctx, grad_out):
    """Kernel C (`msda_backward_op`) with the forward's window. The tanh of
    the windowed rule, the anchor add and the weight softmax stay upstream
    in autograd."""
    value, pos, weights = ctx.saved_tensors
    spatial_shapes, query_shapes, window_radius = ctx.static
    d_value, d_pos, d_weights = msda_backward_op(
        value, spatial_shapes, pos, weights, grad_out.contiguous(),
        query_shapes, window_radius)
    # each gradient in its input's dtype: pos and weights are f32
    return d_value, None, d_pos, d_weights, None, None


# the ops of kernels B and C: level shapes and query grids as flat
# [H0, W0, H1, W1, ...] lists, no query grids and a None radius for
# unbounded offsets; on CPU tensors `msda_plain` and `msda_backward_plain`
_MSDA_ARGS = ("(Tensor value, int[] spatial_shapes, Tensor pos, "
              "Tensor weights, ")
_WINDOW_ARGS = "int[] query_shapes, float? window_radius)"
msda_backward_op = _lib.define_op(
    "msda_backward",
    _MSDA_ARGS + "Tensor grad_out, " + _WINDOW_ARGS
    + " -> (Tensor, Tensor, Tensor)",
    _msda_backward_cpu, _msda_backward_cuda, _msda_backward_fake)
msda_op = _lib.define_op(
    "msda", _MSDA_ARGS + _WINDOW_ARGS + " -> Tensor", _msda_cpu,
    _msda_cuda, _msda_fake, _backward, _setup_context)


def _op_args(value, spatial_shapes, pos, weights, query_shapes,
             window_radius):
    """Check a call and give the ops' arguments: (level shapes, query
    grids) flat, the radius or None."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    query_shapes, radius = _normalise_window(query_shapes, window_radius,
                                             pos.shape[1])
    return (_flat(spatial_shapes),
            [] if radius is None else _flat(query_shapes), radius)


def msda(value, spatial_shapes, pos, weights, query_shapes=None,
         window_radius=None):
    """Deformable sampling over all levels through `msda_op`: kernels B
    (forward) and C (backward) for CUDA tensors, the plain versions for CPU
    tensors.

    `query_shapes` (the row-major query grids, concatenated) and
    `window_radius` tell the kernels that every sample lies within the
    radius, in level pixels, of its query's anchor, as
    `windowed_positions` forms them: the kernels then stage value windows
    in shared memory. They change no result: positions that leave the
    window, or a call without them, are sampled from device memory."""
    shapes, grids, radius = _op_args(value, spatial_shapes, pos, weights,
                                     query_shapes, window_radius)
    return msda_op(value, shapes, pos, weights, grids, radius)


def msda_backward(value, spatial_shapes, pos, weights, grad_out,
                  query_shapes=None, window_radius=None):
    """(d_value, d_pos, d_weights) of `msda` for the cotangent grad_out
    (B, Nq, heads·d) in the value's dtype, through `msda_backward_op`:
    kernel C for CUDA tensors, `msda_backward_plain` for CPU tensors.
    `query_shapes` and `window_radius` as in `msda`. d_value comes in the
    value's dtype (a bf16 one summed in f32 and rounded once), d_pos and
    d_weights in f32. Kernel C sums d_value in an order that changes from
    run to run, and its low bits with it; d_pos and d_weights are
    deterministic."""
    shapes, grids, radius = _op_args(value, spatial_shapes, pos, weights,
                                     query_shapes, window_radius)
    B, _, h, d = value.shape
    if tuple(grad_out.shape) != (B, pos.shape[1], h * d):
        raise ValueError(f"grad_out shape {tuple(grad_out.shape)} != "
                         f"{(B, pos.shape[1], h * d)}")
    return msda_backward_op(value, shapes, pos, weights, grad_out, grids,
                            radius)


msda.launches = 0
msda_backward.launches = 0
# the same launches by queries per sample, which tells a model's
# self-attention from its cross-attention
msda.launches_by_queries = collections.Counter()
msda_backward.launches_by_queries = collections.Counter()
# and by the value's dtype: which instance ran
msda.launches_by_dtype = collections.Counter()
msda_backward.launches_by_dtype = collections.Counter()
