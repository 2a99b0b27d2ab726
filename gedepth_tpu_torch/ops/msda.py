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

The value is f32 or bf16, and each kernel has an instance for either (the
bf16 ones are kernels of their own, `csrc/msda_fwd_bf16.cu` and
`csrc/msda_bwd_bf16.cu`: 16-byte slices of 8 bf16 a lane). Heads of one
or two 16-byte slices (f32 d = 4 or 8, bf16 d = 8 or 16; `narrow_slices`)
take a narrow instance of both, in either dtype (`csrc/msda_narrow.cu`: a
thread a query and head with every channel in its registers, no plan);
the others, the wide instances below. pos
and weights are f32 at the kernels' boundary whatever the value: a bf16
position on a 304-pixel level has a quarter-pixel grid, so a bf16 model
forms them in f32 from its bf16 projections (as the JAX package's kernel
path lifts them). With a bf16 value the output is bf16: the sums are f32
and rounded once, in the kernels and in the plain version alike; kernel C
takes grad_out in bf16 and returns d_value in bf16 (summed in f32, rounded
once), d_pos and d_weights in f32. A bf16 window takes half the shared
memory, so C's plan of a bf16 value stages more.

The wide instances walk a tile plan: a block owns a tile of queries and one
head and, level by level, stages in shared memory a value window around
where the tile's samples fall. With the query grids and the radius that
bounds the offsets (`query_shapes`, `window_radius`) the host plans
(`tile_plan`): a tile is a rectangle of one grid. Without them the card
plans from the positions of the call (`msda_plan`, csrc/msda_plan.cu): it
orders each entry's queries by a robust centre of their samples, cuts the
order into tiles of 128, and stages around each tile's centres the levels
where enough of its samples land; `plan_plain` is its plain version. B's
bf16 instance stages no window (its corner reads hit L1) and takes from
either plan only the order of its queries. The
plan only makes the kernels fast: a sample that leaves its staged window is
read from (and, in C, added to) device memory, so any positions are
sampled correctly, and B's output, C's d_pos and d_weights are the same to
the bit with any plan.

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
# pixels of a window whose corners kernel C's bf16 instance sums in shared
# memory (bins) while reading the window from device memory, where it
# outgrows the stage
BIN_PIXELS_BACKWARD = 1024


def _round_up4(n: int) -> int:
    return -(-n // 4) * 4


def shared_bytes(stage_elems: int, head_dim: int, lanes: int,
                 itemsize: int = 4) -> int:
    """Dynamic shared memory of a block of kernel B. f32 (csrc/msda.cu):
    the staged value window (`stage_elems` floats), the tile's running sums
    (d floats a query), and a 32-byte record for each of the 8 (or `lanes`,
    if fewer) samples a lane group sets up at a time. bf16
    (csrc/msda_fwd_bf16.cu, the sums in registers): the staged bf16 window
    in whole 16-byte units, then the records."""
    records = TILE_THREADS // lanes * min(lanes, 8) * RECORD_BYTES
    if itemsize == 2:
        return -(-2 * stage_elems // 16) * 16 + records
    return (4 * stage_elems + 4 * _round_up4(MAX_TILE_QUERIES * head_dim)
            + records)


def shared_bytes_backward(stage_elems: int, head_dim: int, lanes: int,
                          points: int, itemsize: int = 4,
                          bin_pixels: int = 0) -> int:
    """Dynamic shared memory of the larger block of kernel C.

    f32 (csrc/msda_bwd.cu), its d_value kernel: the tile's grad_out rows,
    the groups' records, the list of (query, coefficient) pairs of every
    corner of the tile's samples on one level, and a count and a bin start
    per pixel of the staged window. (Its d_pos kernel takes the staged
    window plus records and dots: less than kernel B.)

    bf16 (csrc/msda_bwd_bf16.cu, one pass): a region that holds the
    staged bf16 window and then the corners sorted by pixel (the larger of
    the two), the tile's bf16 grad_out rows, a record (which then takes its
    four dots) for each of the 8 (or `lanes`, if fewer) samples a lane
    group sets up at a time and, where corners are binned (`bin_pixels`,
    the most pixels of a bin window), an 8-byte slot for each corner of the
    tile's samples on one level, a count per pixel of the bin window and
    the count of the filed corners."""
    records = TILE_THREADS // lanes * min(lanes, 8)
    if itemsize == 2:
        corners = MAX_TILE_QUERIES * points * 4 * 8 if bin_pixels else 0
        rows = 2 * (-(-MAX_TILE_QUERIES * head_dim // 8) * 8)
        binned = corners + 4 * (bin_pixels + 1) if bin_pixels else 0
        return (max(2 * stage_elems, corners) + rows + records * RECORD_BYTES
                + binned)
    corners = MAX_TILE_QUERIES * points * 4 * 8 if stage_elems else 0
    return (4 * _round_up4(MAX_TILE_QUERIES * head_dim)
            + records * RECORD_BYTES + corners
            + 4 * (2 * (stage_elems // head_dim) + 1))


# share of the room beside its records that kernel B's bf16 instance gives
# a staged window: 0, since reading every corner through L1 was faster at
# every windowed, compat and exact shape of HAHI measured
# (tests/msda_plan_rules.py --budget, which sets it)
STAGE_SHARE_FORWARD_BF16 = 0.0


def stage_budget(head_dim: int, lanes: int, itemsize: int = 4) -> int:
    """Bytes a staged window of kernel B may take so that two blocks share
    an SM; for the bf16 instance, STAGE_SHARE_FORWARD_BF16 of that room, in
    whole 16-byte units."""
    room = max(BLOCK_SHARED_BYTES - shared_bytes(0, head_dim, lanes,
                                                 itemsize), 0)
    if itemsize == 2:
        return int(STAGE_SHARE_FORWARD_BF16 * room) // 16 * 16
    return room


def lanes_of(head_dim: int, aligned: bool = True, itemsize: int = 4):
    """(elements per lane, lanes per query) of the instance of kernels B
    and C that serves a head width. f32 as `channel_lanes`. bf16
    (csrc/msda_fwd_bf16.cu, csrc/msda_bwd_bf16.cu): 16-byte slices of 8 over
    the smallest of 4, 8 or 16 lanes that holds the head, when the head is
    whole 16-byte units and the tensors are 16-byte aligned; else single
    elements over 32 lanes, four rounds at most."""
    if itemsize != 2:
        return channel_lanes(head_dim, aligned)
    if head_dim % 8 == 0 and aligned:
        return 8, next(g for g in (4, 8, 16) if 8 * g >= head_dim)
    return 1, 32


# the launches_by_instance key of the narrow instance: (dtype, NARROW, d)
NARROW = "narrow"


def narrow_slices(head_dim: int, itemsize: int = 4,
                  aligned: bool = True) -> int:
    """16-byte slices of a head that kernels B and C run on their narrow
    instance (csrc/msda_narrow.cu: a thread a query and head, every channel
    in its registers): 1 or 2 for a head of one or two whole slices (f32 d
    = 4 or 8, bf16 d = 8 or 16) with 16-byte aligned tensors; 0 for every
    other launch, which takes the wide instances (`lanes_of`)."""
    slices, rest = divmod(head_dim * itemsize, 16)
    return slices if aligned and rest == 0 and slices in (1, 2) else 0


def stage_budget_backward(head_dim: int, lanes: int, points: int,
                          itemsize: int = 4) -> int:
    """Bytes of staged window that kernel C's plan may give a block so that
    two blocks share an SM. f32: B's budget (`stage_budget`; C's d_value
    kernel fits beside it, else the launch takes the unplanned rows). bf16:
    what the one-pass block leaves beside its rows, records, filed corners
    and the counts of a bin window of BIN_PIXELS_BACKWARD pixels (or, for a
    window larger than that, of the window; the sorted corners take the
    window's region), less 32 bytes for the window's rounding to 16-byte
    units; 0 where the filed corners alone would crowd the block."""
    if itemsize != 2:
        return stage_budget(head_dim, lanes)
    corners = MAX_TILE_QUERIES * points * 4 * 8
    spare = (BLOCK_SHARED_BYTES - 32 - 4 - corners
             - shared_bytes_backward(0, head_dim, lanes, points, 2))
    fixed = spare - 4 * BIN_PIXELS_BACKWARD
    if fixed < corners:
        return 0
    pixels = fixed // (2 * head_dim)
    if pixels > BIN_PIXELS_BACKWARD:      # the counts grow with the window
        pixels = spare // (2 * head_dim + 4)
    return pixels * 2 * head_dim


def backward_bins(head_dim: int, stage_bytes: int, itemsize: int = 4) -> int:
    """The most pixels of a window whose corners kernel C bins without
    staging it (bf16: BIN_PIXELS_BACKWARD, or the staged window's pixels if
    more); 0 for the f32 instance, which bins only what it stages."""
    if itemsize != 2 or stage_bytes <= 0:
        return 0
    return max(stage_bytes // (itemsize * head_dim), BIN_PIXELS_BACKWARD)


# query-tile shapes tried per query grid, largest first
TILE_CANDIDATES = ((8, 16), (8, 8), (4, 8))
# ints of a tile's row before its per-level rectangles
TILE_HEADER = 6

# The plan made on the card (csrc/msda_plan.cu, `plan_plain`): queries of a
# histogram chunk, the most cell ids (and the one of no cell), the queries a
# cell of the finest level should hold at most (its side is a power of 2),
# every how many queries of a tile count, the most levels, the margins
# counted one by one (and the rest in one bin), and the percent of the
# counted samples a margin should hold (kCoverPct there)
PLAN_CHUNK = 1024
PLAN_MAX_IDS = 8193
PLAN_CELL_QUERIES = 16
PLAN_SHARE_STRIDE = 16
PLAN_MAX_LEVELS = 8
PLAN_MARGIN_BINS = 64
PLAN_COVER_PCT = 97


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


def channel_lanes(head_dim: int, aligned: bool = True):
    """(elements per lane, lanes per query) of the f32 kernel instances
    that serve a head width: slices of 4 floats over the smallest of 4, 8,
    16 or 32 lanes that holds the head, when the head is whole 16-byte units
    (a window is staged in 16-byte copies); else (or when the tensors are
    not 16-byte aligned) single elements over 32 lanes, four rounds at
    most."""
    if head_dim % 4 == 0 and aligned:
        return 4, next(g for g in (4, 8, 16, 32) if 4 * g >= head_dim)
    return 1, 32


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Query tiles of one launch. `rows` is (tiles, TILE_HEADER + 4·L)
    int32: the tile's grid (first query, grid width), its rectangle of that
    grid (y0, x0, height, width), then for each level the staged value
    rectangle (y_lo, x_lo, height, width), height 0 where the level is
    gathered from device memory, and −height where the rectangle is only
    binned (its corners' d_value summed in shared memory, the value read
    from device memory: kernel C's bf16 instance)."""
    rows: np.ndarray
    stage_elems: int         # elements of the largest staged rectangle
    bin_pixels: int = 0      # pixels of the largest rectangle, staged or not


def _grid_rows(q_start, grid, tile, spatial_shapes, margin, max_pixels,
               bin_pixels=0):
    """Rows of one query grid cut into `tile`s, and how many (query, level)
    pairs they stage. A level's rectangle covers the anchors of the tile's
    queries ± margin, clipped to the level; one larger than `max_pixels`
    but within `bin_pixels` is binned alone (height negated)."""
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
                    elif 0 < rh * rw <= bin_pixels:
                        rect = (y_lo, x_lo, -rh, rw)
                row.extend(rect)
            rows.append(row)
    return rows, staged


@functools.lru_cache(maxsize=64)
def tile_plan(query_shapes, spatial_shapes, radius, head_dim, stage_bytes,
              itemsize=4, bin_pixels=0):
    """The tile plan of a launch: `query_shapes` row-major query grids,
    concatenated, sampling `spatial_shapes` with offsets bounded by
    `radius` level pixels around each query's anchor (None: unbounded,
    nothing is staged and the queries are one row). Per grid, the tile
    shape that stages the most (query, level) pairs within `stage_bytes`,
    the larger shape on a tie; a rectangle past the stage but within
    `bin_pixels` is binned alone. `itemsize`: bytes of a value element (4
    for f32, 2 for bf16)."""
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
                                     margin, max_pixels, bin_pixels)
            if best is None or staged > best[1]:
                best = (got, staged)
        rows.extend(best[0])
        q_start += grid[0] * grid[1]
    rows = np.asarray(rows, np.int32).reshape(
        -1, TILE_HEADER + 4 * len(spatial_shapes))
    rects = rows[:, TILE_HEADER:].reshape(len(rows), -1, 4)
    stage_pixels = int((rects[:, :, 2] * rects[:, :, 3]).max(initial=0))
    bin_px = int((np.abs(rects[:, :, 2]) * rects[:, :, 3]).max(initial=0))
    # whole 16-byte units: the kernels lay their records after the stage
    unit = 16 // itemsize
    stage_elems = -(-stage_pixels * head_dim // unit) * unit
    return TilePlan(rows, stage_elems, bin_px)


@functools.lru_cache(maxsize=64)
def _tile_table(query_shapes, spatial_shapes, radius, head_dim, stage_bytes,
                itemsize, bin_pixels, device):
    plan = tile_plan(query_shapes, spatial_shapes, radius, head_dim,
                     stage_bytes, itemsize, bin_pixels)
    # a normal tensor even under inference_mode (see `_level_table`)
    with torch.inference_mode(False):
        return torch.as_tensor(plan.rows, device=device), plan


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Sizes of a plan made from the positions: the finest level (the keys'
    level), log2 of a cell's side in its pixels, blocks of 8x8 cells in a
    row, cell ids (64 a block) plus the one of no cell, histogram chunks
    and tiles an entry, the most pixels of a staged rectangle and the
    elements the kernels reserve for it (whole 16-byte units)."""
    level0: int
    shift: int
    n_tx: int
    n_ids: int
    n_chunks: int
    n_tiles: int
    max_pixels: int
    stage_elems: int


@functools.lru_cache(maxsize=64)
def device_plan_shape(spatial_shapes, n_queries, head_dim, stage_bytes,
                      itemsize=4):
    """The `DevicePlan` of a launch: cells of the finest level as large as
    hold about PLAN_CELL_QUERIES queries (the queries spread evenly), larger
    where the ids would pass PLAN_MAX_IDS."""
    sizes = [H_ * W_ for (H_, W_) in spatial_shapes]
    level0 = sizes.index(max(sizes))
    H0, W0 = spatial_shapes[level0]
    density = n_queries / (H0 * W0)

    def ids(shift):
        Hc, Wc = ((H0 - 1) >> shift) + 1, ((W0 - 1) >> shift) + 1
        n_tx = -(-Wc // 8)
        return -(-Hc // 8) * n_tx * 64 + 1, n_tx

    shift = 0
    while (4 ** (shift + 1) * density <= PLAN_CELL_QUERIES
           and 2 ** (shift + 1) <= max(H0, W0)):
        shift += 1
    while ids(shift)[0] > PLAN_MAX_IDS:
        shift += 1
    n_ids, n_tx = ids(shift)
    max_pixels = stage_bytes // (itemsize * head_dim)
    unit = 16 // itemsize
    return DevicePlan(level0, shift, n_tx, n_ids,
                      -(-n_queries // PLAN_CHUNK),
                      -(-n_queries // MAX_TILE_QUERIES), max_pixels,
                      -(-max_pixels * head_dim // unit) * unit)


def _morton3(y, x):
    m = torch.zeros_like(x)
    for i in range(3):
        m |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1)
    return m


def _cells_of(ids, n_tx):
    """(cy, cx) of cell ids: blocks of 8x8 cells in raster order, Morton
    order inside a block."""
    t, m = ids >> 6, ids & 63
    x = sum(((m >> (2 * i)) & 1) << i for i in range(3))
    y = sum(((m >> (2 * i + 1)) & 1) << i for i in range(3))
    return (t // n_tx) * 8 + y, (t % n_tx) * 8 + x


def plan_keys_plain(pos, spatial_shapes, plan):
    """(B, Nq) int64 cell id of each query: the per-axis lower median of
    the cells of its samples on the finest level (32 spread evenly over its
    h·P where there are more) that have a corner inside it; plan.n_ids − 1
    for a query with none."""
    B, Nq, h, L, P, _ = pos.shape
    H0, W0 = spatial_shapes[plan.level0]
    xy = pos[:, :, :, plan.level0].float().reshape(B, Nq, h * P, 2)
    if h * P > 32:          # 32 spread evenly over them
        xy = xy[:, :, torch.arange(32, device=pos.device) * (h * P) // 32]
    x, y = xy[..., 0], xy[..., 1]
    ok = (x > -1) & (x < W0) & (y > -1) & (y < H0)
    big = 1 << 30

    def median(v, n_):
        c = torch.where(ok, v, 0).floor().long().clamp(0, n_ - 1)
        c = torch.where(ok, c >> plan.shift, big).sort(-1).values
        k = (ok.sum(-1) - 1).clamp_min(0) // 2
        return c.gather(-1, k[..., None])[..., 0]

    mx, my = median(x, W0), median(y, H0)
    ids = ((my >> 3) * plan.n_tx + (mx >> 3)) * 64 + _morton3(my & 7, mx & 7)
    return torch.where(ok.any(-1), ids, plan.n_ids - 1)


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _map_range(a, b, n0, nl):
    """Level pixels [lo, hi] that the finest level's pixels [a, b] map to
    (csrc/msda_plan.cu `map_range`)."""
    lo = _floor_div((2 * a + 1) * nl - n0, 2 * n0).clamp_min(0)
    hi = _floor_div((2 * b + 3) * nl - n0, 2 * n0).clamp_max(nl - 1)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class PlanTensors:
    """A plan made from the positions: `keys` and `perm` (B, Nq), `rows`
    (B·n_tiles, TILE_HEADER + 4·L) int32, a tile's first int an offset into
    the flattened perm; `touched` and `staged` (B·n_tiles, L): how many
    samples of every PLAN_SHARE_STRIDE-th query of the tile touch the level,
    and how many of them the chosen margin holds (a margin past the
    counted ones counts as the last; zeros where not even the box fits).
    The last two only from `plan_plain`."""
    keys: torch.Tensor
    perm: torch.Tensor
    rows: torch.Tensor
    touched: torch.Tensor | None = None
    staged: torch.Tensor | None = None


def plan_plain(pos, spatial_shapes, head_dim, stage_bytes, itemsize=4):
    """Plain version of the planning kernel (csrc/msda_plan.cu), integer for
    integer, on any device: the queries of each entry ordered by their
    keys, ties by index (a stable sort); a tile of each 128 of that order;
    for each tile and level the box of the tile's keys mapped to the level,
    grown by the least margin that holds the four corners of
    PLAN_COVER_PCT percent of the counted samples touching the level (the
    largest margin that keeps it within the pixels `stage_bytes` holds,
    where that holds fewer) and clipped, staged wherever the box fits and a
    counted sample touches the level."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    B, Nq, h, L, P, _ = pos.shape
    plan = device_plan_shape(spatial_shapes, Nq, head_dim, stage_bytes,
                             itemsize)
    keys = plan_keys_plain(pos, spatial_shapes, plan)
    perm = torch.sort(keys, dim=1, stable=True).indices
    T, Q = plan.n_tiles, MAX_TILE_QUERIES
    pad = T * Q - Nq
    none = plan.n_ids - 1
    sorted_ids = torch.nn.functional.pad(keys.gather(1, perm), (0, pad),
                                         value=none).view(B, T, Q)
    valid = sorted_ids != none
    cy, cx = _cells_of(sorted_ids, plan.n_tx)
    big = 1 << 30
    box = [torch.where(valid, c, big).amin(-1) for c in (cy, cx)]
    box_hi = [torch.where(valid, c, -big).amax(-1) for c in (cy, cx)]
    has = valid.any(-1)
    H0, W0 = spatial_shapes[plan.level0]
    # every PLAN_SHARE_STRIDE-th query of each tile (-1: past the last)
    sub = torch.arange(0, Q, PLAN_SHARE_STRIDE, device=pos.device)
    counted = torch.nn.functional.pad(perm, (0, pad), value=-1).view(
        B, T, Q)[:, :, sub]
    live = counted >= 0
    flat = pos.reshape(B, Nq, h, L, P, 2)
    picked = flat[torch.arange(B, device=pos.device)[:, None, None],
                  counted.clamp_min(0)]                # (B, T, n, h, L, P, 2)
    cnt = torch.clamp(Nq - torch.arange(T, device=pos.device) * Q, max=Q)
    rows = torch.zeros(B, T, TILE_HEADER + 4 * L, dtype=torch.int64,
                       device=pos.device)
    rows[:, :, 0] = (torch.arange(B, device=pos.device)[:, None] * Nq
                     + torch.arange(T, device=pos.device)[None] * Q)
    rows[:, :, 1] = -1
    rows[:, :, 4] = 1
    rows[:, :, 5] = cnt
    touched = torch.zeros(B, T, L, dtype=torch.int64, device=pos.device)
    staged = torch.zeros_like(touched)
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        ylo, yhi = _map_range(box[0] << plan.shift,
                              torch.clamp(((box_hi[0] + 1) << plan.shift) - 1,
                                          max=H0 - 1), H0, Hl)
        xlo, xhi = _map_range(box[1] << plan.shift,
                              torch.clamp(((box_hi[1] + 1) << plan.shift) - 1,
                                          max=W0 - 1), W0, Wl)

        def area(m):
            return ((torch.clamp(yhi + m, max=Hl - 1)
                     - torch.clamp(ylo - m, min=0) + 1)
                    * (torch.clamp(xhi + m, max=Wl - 1)
                       - torch.clamp(xlo - m, min=0) + 1))

        # the largest margin that fits the budget (-1: not even the box)
        lo = torch.zeros_like(ylo)
        hi = torch.full_like(ylo, max(Hl, Wl))
        while bool((lo < hi).any()):
            active = lo < hi
            mid = (lo + hi + 1) >> 1
            ok = area(mid) <= plan.max_pixels
            lo = torch.where(active & ok, mid, lo)
            hi = torch.where(active & ~ok, mid - 1, hi)
        fits = torch.where(has & (area(0) <= plan.max_pixels), lo, -1)
        # the margin each counted sample needs, cornered as kernels B and C
        # clamp them
        x0f = picked[..., l, :, 0].floor()      # (B, T, n, h, P)
        y0f = picked[..., l, :, 1].floor()
        touch = ((fits >= 0)[:, :, None, None, None] & live[..., None, None]
                 & (x0f >= -1) & (x0f < Wl) & (y0f >= -1) & (y0f < Hl))
        x0 = torch.where(touch, x0f, 0).long()
        y0 = torch.where(touch, y0f, 0).long()
        at = (slice(None), slice(None), None, None, None)
        m = torch.stack([ylo[at] - y0.clamp_min(0),
                         (y0 + 1).clamp_max(Hl - 1) - yhi[at],
                         xlo[at] - x0.clamp_min(0),
                         (x0 + 1).clamp_max(Wl - 1) - xhi[at]]).amax(0)
        bins = m.clamp(0, PLAN_MARGIN_BINS - 1)
        hist = torch.zeros(B, T, PLAN_MARGIN_BINS, dtype=torch.int64,
                           device=pos.device).scatter_add_(
            2, bins.view(B, T, -1), touch.view(B, T, -1).long())
        n = touch.sum((2, 3, 4))
        held_at = hist.cumsum(-1)
        last = torch.clamp(fits, max=PLAN_MARGIN_BINS - 2)
        reach = ((100 * held_at >= PLAN_COVER_PCT * n[..., None])
                 & (torch.arange(PLAN_MARGIN_BINS, device=pos.device)
                    <= last[..., None]))
        covered = reach.any(-1)
        first = reach.long().argmax(-1)
        margin = torch.where(covered, first, fits)
        held = held_at.gather(-1, torch.where(covered, first, last)
                              .clamp_min(0)[..., None])[..., 0]
        on = (fits >= 0) & (n > 0)     # staged
        ry, rx = torch.clamp(ylo - margin, min=0), torch.clamp(xlo - margin,
                                                               min=0)
        rh = torch.clamp(yhi + margin, max=Hl - 1) - ry + 1
        rw = torch.clamp(xhi + margin, max=Wl - 1) - rx + 1
        rect = torch.stack([ry, rx, rh, rw], -1)
        rows[:, :, TILE_HEADER + 4 * l:TILE_HEADER + 4 * l + 4] = torch.where(
            on[..., None], rect, 0)
        touched[:, :, l], staged[:, :, l] = n, held
    return PlanTensors(keys.to(torch.int32), perm.to(torch.int32),
                       rows.view(B * T, -1).to(torch.int32),
                       touched.view(B * T, L), staged.view(B * T, L))


def msda_plan(pos, spatial_shapes, head_dim, stage_bytes, itemsize=4):
    """The tile plan of an unhinted launch of B or C, made from the
    positions (`plan_plain` describes it): the planning kernel of
    csrc/msda_plan.cu on a CUDA tensor, which waits for nothing on the host
    (the sizes follow from the shapes; every buffer is allocated here),
    `plan_plain` on a CPU tensor. Returns `PlanTensors` (keys, perm, rows)
    on pos's device. pos: (B, Nq, h, L, P, 2) f32, contiguous, L <=
    PLAN_MAX_LEVELS."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    if pos.device.type == "cpu":
        got = plan_plain(pos, spatial_shapes, head_dim, stage_bytes,
                         itemsize)
        return PlanTensors(got.keys, got.perm, got.rows)
    if pos.device.type != "cuda":
        raise ValueError(f"msda_plan: no kernel for {pos.device}")
    B, Nq, h, L, P, _ = pos.shape
    if pos.dtype != torch.float32 or not pos.is_contiguous() \
            or pos.data_ptr() % 8:
        raise ValueError("msda_plan takes contiguous, 8-byte aligned f32 "
                         "positions")
    if L > PLAN_MAX_LEVELS:
        raise ValueError(f"msda_plan: {UNPLANNED_LEVELS} ({L} levels)")
    plan = device_plan_shape(spatial_shapes, Nq, head_dim, stage_bytes,
                             itemsize)
    width = TILE_HEADER + 4 * L
    sizes = (B * Nq, B * (plan.n_chunks + 1) * plan.n_ids, B * Nq,
             B * plan.n_tiles * width)
    keys, hist, perm, rows = torch.empty(
        sum(sizes), dtype=torch.int32, device=pos.device).split(sizes)
    levels = _level_table(spatial_shapes, pos.device)
    _lib.call("msda_plan", pos.data_ptr(), levels.data_ptr(),
              keys.data_ptr(), hist.data_ptr(), perm.data_ptr(),
              rows.data_ptr(), B, Nq, h, L, P, plan.level0, plan.shift,
              plan.n_tx, plan.n_ids, plan.max_pixels)
    msda_plan.launches += 1
    msda_plan.launches_by_queries[Nq] += 1
    return PlanTensors(keys.view(B, Nq), perm.view(B, Nq),
                       rows.view(B * plan.n_tiles, width))


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


# The unhinted launches that walk the unplanned rows (`tile_plan` without a
# radius: 128 queries a tile in index order, nothing staged); the wrapper
# counts them by reason (`msda.unplanned`, `msda_backward.unplanned`). More
# levels than a plan holds, and a corner list that outgrows an SM, are
# inputs the plan cannot take. Narrow corners are not: at them the plan
# does not yet pay for itself (its five dependent launches and its host
# time cost more than staging saves), and they stay on the unplanned rows
# until it does.
UNPLANNED_LEVELS = "more levels than a plan holds"
UNPLANNED_CORNER = "narrow corners: the plan costs more than it saves yet"
# The least bytes of a corner with which a launch of the wide instances
# plans (the narrow instance plans nothing), measured on the H100 by
# tests/msda_plan_rules.py: B reads d elements of the value a corner
# (f32 at d = 64 gains by the plan; bf16 at d = 64, whose kernel reads
# through L1 and gains ~8% by the plan's order, loses that to the plan's
# launches and host time; d = 8 loses by it in either dtype); C adds d f32
# sums a corner (d = 64 gains in f32 and bf16, d = 8 loses)
PLAN_MIN_CORNER_BYTES_FORWARD = 256
PLAN_MIN_CORNER_BYTES_BACKWARD = 128
UNPLANNED_CORNERS = "a tile's corner list outgrows an SM"


@dataclasses.dataclass(frozen=True)
class _Launch:
    """What a launch of B or C takes besides its tensors."""
    levels: int
    tiles: int
    perm: int              # 0: the rows are a host plan's
    n_tiles: int
    stage_elems: int
    vec: int
    lanes: int
    bin_pixels: int        # pixels of the largest binned rectangle (bf16 C)
    keep: tuple = ()       # the device plan's tensors, alive until launch


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _forward_geometry(value, out):
    """(vec, lanes, stage bytes, bin pixels) of a launch of B."""
    d, itemsize = value.shape[3], value.element_size()
    vec, lanes = lanes_of(d, _aligned(value, out), itemsize)
    return vec, lanes, stage_budget(d, lanes, itemsize), 0


def _backward_geometry(value, points, *tensors):
    """(vec, lanes, stage bytes, bin pixels) of a launch of C."""
    d, itemsize = value.shape[3], value.element_size()
    vec, lanes = lanes_of(d, _aligned(value, *tensors), itemsize)
    budget = stage_budget_backward(d, lanes, points, itemsize)
    return vec, lanes, budget, backward_bins(d, budget, itemsize)


def _plan_args(value, spatial_shapes, window, pos, unplanned, geometry):
    """The kernel instance and plan of a launch of `geometry` (vec, lanes,
    stage bytes, bin pixels). With a window hint the host plan
    (`tile_plan`); without one the plan made on the card from `pos`
    (`msda_plan`), unless `unplanned` names why the launch cannot take it
    (or is True: the caller asks for the unplanned rows)."""
    d, itemsize = value.shape[3], value.element_size()
    vec, lanes, stage_bytes, bins = geometry
    levels = _level_table(spatial_shapes, value.device)
    query_shapes, radius = window
    if radius is None and not unplanned:
        got = msda_plan(pos, spatial_shapes, d, stage_bytes, itemsize)
        plan = device_plan_shape(spatial_shapes, pos.shape[1], d, stage_bytes,
                                 itemsize)
        return _Launch(levels.data_ptr(), got.rows.data_ptr(),
                       got.perm.data_ptr(), plan.n_tiles, plan.stage_elems,
                       vec, lanes, plan.max_pixels if plan.stage_elems else 0,
                       (got.perm, got.rows))
    table, plan = _tile_table(query_shapes, spatial_shapes, radius, d,
                              stage_bytes, itemsize, bins, value.device)
    return _Launch(levels.data_ptr(), table.data_ptr(), 0, len(plan.rows),
                   plan.stage_elems, vec, lanes, plan.bin_pixels)


def _entry(name, value):
    return name + "_bf16" if value.dtype == torch.bfloat16 else name


def _plan_reason(value, pos, forward):
    """Why a launch of B (`forward`) or C takes the unplanned rows, or
    None."""
    if pos.shape[3] > PLAN_MAX_LEVELS:
        return UNPLANNED_LEVELS
    d = value.shape[3]
    if (d * value.element_size() < PLAN_MIN_CORNER_BYTES_FORWARD if forward
            else 4 * d < PLAN_MIN_CORNER_BYTES_BACKWARD):
        return UNPLANNED_CORNER
    return None


def _count(counted, value, Nq, instance, unplanned=None):
    """One launch of B (`msda`) or C (`msda_backward`) in its counters."""
    counted.launches += 1
    counted.launches_by_queries[Nq] += 1
    counted.launches_by_dtype[value.dtype] += 1
    counted.launches_by_instance[instance] += 1
    if unplanned:
        counted.unplanned[unplanned] += 1


def _takes_narrow(value, *tensors):
    """Whether a launch takes the narrow instance (`narrow_slices`)."""
    return narrow_slices(value.shape[3], value.element_size(),
                         _aligned(value, *tensors)) > 0


def _narrow_counts(value, window):
    """The instance key of a narrow launch, and the reason under which an
    unhinted one counts as unplanned: it takes no plan, hinted or not."""
    return ((value.dtype, NARROW, value.shape[3]),
            UNPLANNED_CORNER if window[1] is None else None)


def _vector_rows(pos, *rows):
    """1 where a narrow launch reads (and C writes) its rows of positions
    and weights 16 bytes at a time: P a multiple of 4, every row tensor
    16-byte aligned."""
    return int(pos.shape[4] % 4 == 0 and _aligned(pos, *rows))


def _launch_forward(value, spatial_shapes, pos, weights, window,
                    planned=True, wide=False):
    """Kernel B on CUDA tensors already checked: the narrow instance where
    `narrow_slices` says so, else the wide ones over their plan.
    planned=False: the wide instance over the unplanned rows, whatever the
    window (what a plan is held against); wide=True: the wide instance as
    it would run without the narrow one (what the narrow one is held
    against)."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    out = value.new_empty(B, Nq, h * d)
    if planned and not wide and _takes_narrow(value, out):
        _lib.call(_entry("msda_narrow_fwd", value), value.data_ptr(),
                  _level_table(spatial_shapes, value.device).data_ptr(),
                  pos.data_ptr(), weights.data_ptr(), out.data_ptr(), B, S,
                  Nq, h, d, L, P, _vector_rows(pos, weights))
        _count(msda, value, Nq, *_narrow_counts(value, window))
        return out
    unplanned = None
    if planned and window[1] is None:
        unplanned = _plan_reason(value, pos, True)
        if unplanned:
            msda.unplanned[unplanned] += 1
    elif not planned:
        window, unplanned = (((1, Nq),), None), True
    a = _plan_args(value, spatial_shapes, window, pos, unplanned,
                   _forward_geometry(value, out))
    _lib.call(_entry("msda_fwd", value), value.data_ptr(), a.levels, a.tiles,
              a.perm, pos.data_ptr(), weights.data_ptr(), out.data_ptr(), B,
              S, Nq, h, d, L, P, a.n_tiles, a.stage_elems, a.vec, a.lanes)
    _count(msda, value, Nq, (value.dtype, a.vec, a.lanes))
    return out


def _launch_backward(value, spatial_shapes, pos, weights, grad_out, window,
                     planned=True, wide=False):
    """Kernel C on CUDA tensors already checked; `planned` and `wide` as in
    `_launch_forward`."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    d_value = torch.empty_like(value)
    # the f32 sums (zeroed by the C entry point): d_value itself when f32
    acc = (d_value if value.dtype == torch.float32
           else torch.empty_like(value, dtype=torch.float32))
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)
    if planned and not wide and _takes_narrow(value, grad_out, d_value, acc):
        _lib.call(_entry("msda_narrow_bwd", value), value.data_ptr(),
                  _level_table(spatial_shapes, value.device).data_ptr(),
                  pos.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
                  acc.data_ptr(), d_value.data_ptr(), d_pos.data_ptr(),
                  d_weights.data_ptr(), B, S, Nq, h, d, L, P,
                  _vector_rows(pos, weights, d_pos, d_weights))
        _count(msda_backward, value, Nq, *_narrow_counts(value, window))
        return d_value, d_pos, d_weights
    geometry = _backward_geometry(value, P, grad_out, d_value, acc)
    unplanned = None
    if not planned:
        window, unplanned = (((1, Nq),), None), True
    else:
        _, lanes, budget, bins = geometry
        itemsize = value.element_size()
        if window[1] is None:
            unplanned = _plan_reason(value, pos, False)
            plan = device_plan_shape(spatial_shapes, Nq, d, budget, itemsize)
            stage_elems = plan.stage_elems
            bin_px = plan.max_pixels if stage_elems else 0
        else:
            plan = tile_plan(window[0], spatial_shapes, window[1], d, budget,
                             itemsize, bins)
            stage_elems, bin_px = plan.stage_elems, plan.bin_pixels
        if shared_bytes_backward(stage_elems, d, lanes, P, itemsize,
                                 bin_px) > SM_SHARED_BYTES - 1024:
            # so many points that a tile's corner list outgrows an SM: no
            # bins
            unplanned = UNPLANNED_CORNERS
            window = (((1, Nq),), None)
        if unplanned:
            msda_backward.unplanned[unplanned] += 1
    a = _plan_args(value, spatial_shapes, window, pos, unplanned, geometry)
    # the bf16 instance also takes the pixels of its largest bin window
    bins = (a.bin_pixels,) if value.dtype == torch.bfloat16 else ()
    _lib.call(_entry("msda_bwd", value), value.data_ptr(), a.levels, a.tiles,
              a.perm, pos.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
              acc.data_ptr(), d_value.data_ptr(), d_pos.data_ptr(),
              d_weights.data_ptr(), B, S, Nq, h, d, L, P, a.n_tiles,
              a.stage_elems, *bins, a.vec, a.lanes)
    _count(msda_backward, value, Nq, (value.dtype, a.vec, a.lanes))
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
    `windowed_positions` forms them: the host then plans the value windows
    the kernels stage in shared memory. Without them the card plans them
    from the positions (`msda_plan`). Neither changes a result: positions
    that leave their window are sampled from device memory."""
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


def msda_unplanned(value, spatial_shapes, pos, weights):
    """Kernel B over the unplanned rows (128 queries a tile in index order,
    nothing staged), on CUDA tensors: what the card's plan is held against.
    The main path never calls it."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    _check_kernel_inputs(value, spatial_shapes, pos, weights)
    return _launch_forward(value, spatial_shapes, pos, weights, None,
                           planned=False)


def msda_backward_unplanned(value, spatial_shapes, pos, weights, grad_out):
    """Kernel C over the unplanned rows, as `msda_unplanned`."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    _check_kernel_inputs(value, spatial_shapes, pos, weights, grad_out)
    return _launch_backward(value, spatial_shapes, pos, weights, grad_out,
                            None, planned=False)


def msda_wide(value, spatial_shapes, pos, weights, query_shapes=None,
              window_radius=None):
    """Kernel B as `msda` launches it, but on the wide instances also where
    the narrow one serves (`narrow_slices`), on CUDA tensors: what the
    narrow instance is held against. The main path never calls it."""
    shapes, grids, radius = _op_args(value, spatial_shapes, pos, weights,
                                     query_shapes, window_radius)
    shapes = _pairs(shapes)
    _check_kernel_inputs(value, shapes, pos, weights)
    return _launch_forward(value, shapes, pos, weights,
                           _window(grids, radius, pos.shape[1]), wide=True)


def msda_backward_wide(value, spatial_shapes, pos, weights, grad_out,
                       query_shapes=None, window_radius=None):
    """Kernel C on the wide instances, as `msda_wide`."""
    shapes, grids, radius = _op_args(value, spatial_shapes, pos, weights,
                                     query_shapes, window_radius)
    shapes = _pairs(shapes)
    _check_kernel_inputs(value, shapes, pos, weights, grad_out)
    return _launch_backward(value, shapes, pos, weights, grad_out,
                            _window(grids, radius, pos.shape[1]), wide=True)


msda.launches = 0
msda_backward.launches = 0
# the same launches by queries per sample, which tells a model's
# self-attention from its cross-attention
msda.launches_by_queries = collections.Counter()
msda_backward.launches_by_queries = collections.Counter()
# and by the value's dtype: which instance ran
msda.launches_by_dtype = collections.Counter()
msda_backward.launches_by_dtype = collections.Counter()
# the launches of B and C by (dtype, elements a lane, lanes a query): which
# instance and lane geometry ran
msda.launches_by_instance = collections.Counter()
msda_backward.launches_by_instance = collections.Counter()
# the launches that walked the unplanned rows by design, by reason
msda.unplanned = collections.Counter()
msda_backward.unplanned = collections.Counter()
msda_plan.launches = 0
msda_plan.launches_by_queries = collections.Counter()
