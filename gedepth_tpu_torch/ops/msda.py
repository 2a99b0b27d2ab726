"""Multi-scale deformable sampling and the windowed position rule.

`msda(value, spatial_shapes, pos, weights)` samples every level of a
flattened value with zero-padded bilinear interpolation at positions given
in level pixels and sums the weighted samples:

  value    (B, ΣHW, heads, d)   the value projection output, levels stacked
  pos      (B, Nq, heads, L, P, 2)  (x, y) level pixels, x = loc·W − 0.5
  weights  (B, Nq, heads, L, P)
  returns  (B, Nq, heads·d)

On a CUDA tensor the wrapper runs `MSDAFunction`: the hand-written
forward kernel of `csrc/msda.cu` (B) and, under autograd, the backward
kernel of `csrc/msda_bwd.cu` (C), which emits d_value, d_pos and d_weights.
On a CPU tensor it runs the plain per-level gather, which autograd
differentiates; `msda_backward_plain` is kernel C's plain twin.

Both kernels walk a tile plan (`tile_plan`): a block owns a rectangle of
one query grid and one head and, level by level, stages in shared memory
the value window its queries can reach. The plan needs the query grids
and the radius that bounds the offsets (`query_shapes`, `window_radius`);
without them every level is gathered from device memory. The plan only
makes the kernels fast: a sample that leaves its staged window is read
from (and, in C, added to) device memory, so any positions are sampled
correctly.

The sampling modes of `gedepth_tpu.ops.msda` differ only in how positions
are formed. `windowed_positions` is the windowed rule: each query's anchor
on the level (its grid centre, split into an integer anchor and a residual
from the float64 table of `gedepth_tpu.ops.msda._axis_anchor_residual`)
plus the bounded offset R·tanh(off/R).
"""
from __future__ import annotations

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


def shared_bytes(stage_floats: int, head_dim: int, lanes: int) -> int:
    """Dynamic shared memory of a block of kernel B: the staged value
    window, the tile's running sums (d floats a query), and a 32-byte
    record for each of the 8 (or `lanes`, if fewer) samples a lane group
    sets up at a time."""
    records = TILE_THREADS // lanes * min(lanes, 8) * RECORD_BYTES
    return (4 * (stage_floats + _round_up4(MAX_TILE_QUERIES * head_dim))
            + records)


def shared_bytes_backward(stage_floats: int, head_dim: int, lanes: int,
                          points: int) -> int:
    """Dynamic shared memory of the larger block of kernel C, the d_value
    kernel: the tile's grad_out rows, the groups' records, the list of
    (query, coefficient) pairs of every corner of the tile's samples on one
    level, and a count and a bin start per pixel of the staged window. (Its
    d_pos kernel takes the staged window plus records and dots: less than
    kernel B.)"""
    records = TILE_THREADS // lanes * min(lanes, 8) * RECORD_BYTES
    corners = MAX_TILE_QUERIES * points * 4 * 8 if stage_floats else 0
    return (4 * _round_up4(MAX_TILE_QUERIES * head_dim) + records + corners
            + 4 * (2 * (stage_floats // head_dim) + 1))


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


def windowed_positions(offsets, query_shapes, spatial_shapes, radius):
    """Level-pixel sample positions of the windowed rule.

    offsets: (B, Nq, heads, L, P, 2) raw offsets (x, y); the queries are
    the row-major grids `query_shapes`, concatenated. Returns the positions
    anchor + (residual + R·tanh(off/R)), the residual sum in f32 as the JAX
    package forms it.
    """
    anc, res = _anchor_tables(tuple(map(tuple, query_shapes)),
                              tuple(map(tuple, spatial_shapes)),
                              offsets.device)
    R = float(radius)
    bounded = R * torch.tanh(offsets / R)
    return ((res[None, :, None, :, None, :] + bounded)
            + anc[None, :, None, :, None, :])


def channel_lanes(head_dim: int, aligned: bool = True):
    """(floats per lane, lanes per query) of the kernel instance that
    serves a head width: 16-byte slices over the smallest of 4, 8, 16 or
    32 lanes that holds a multiple of 4, else (or when the tensors are not
    16-byte aligned) single floats over 32 lanes, four rounds at most."""
    if head_dim % 4 == 0 and aligned:
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
    stage_floats: int        # floats of the largest staged rectangle


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
def tile_plan(query_shapes, spatial_shapes, radius, head_dim, stage_bytes):
    """The tile plan of a launch: `query_shapes` row-major query grids,
    concatenated, sampling `spatial_shapes` with offsets bounded by
    `radius` level pixels around each query's anchor (None: unbounded,
    nothing is staged and the queries are one row). Per grid, the tile
    shape that stages the most (query, level) pairs within `stage_bytes`,
    the larger shape on a tie."""
    max_pixels = stage_bytes // (4 * head_dim)
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
    stage_floats = -(-stage_pixels * head_dim // 4) * 4
    return TilePlan(rows, stage_floats)


@functools.lru_cache(maxsize=64)
def _tile_table(query_shapes, spatial_shapes, radius, head_dim, stage_bytes,
                device):
    plan = tile_plan(query_shapes, spatial_shapes, radius, head_dim,
                     stage_bytes)
    # a normal tensor even under inference_mode (see `_level_table`)
    with torch.inference_mode(False):
        return torch.as_tensor(plan.rows, device=device), plan


def msda_plain(value, spatial_shapes, pos, weights):
    """Plain PyTorch version: four corner gathers per level, chunked over
    queries."""
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


def _check_kernel_inputs(value, spatial_shapes, pos, *tensors):
    """What kernels B and C do not take raises here: nothing falls back to
    the plain version on a CUDA tensor."""
    for t in (value, pos, *tensors):
        if t.device.type != "cuda":
            raise ValueError(f"msda: no kernel for {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"msda kernel is f32, got {t.dtype}")
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
    count, stage floats, floats per lane, lanes per query)."""
    d = value.shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in (value, *tensors))
    vec, lanes = channel_lanes(d, aligned)
    query_shapes, radius = window
    table, plan = _tile_table(query_shapes, spatial_shapes, radius, d,
                              stage_budget(d, lanes), value.device)
    levels = _level_table(spatial_shapes, value.device)
    return (levels.data_ptr(), table.data_ptr(), len(plan.rows),
            plan.stage_floats, vec, lanes)


def _launch_forward(value, spatial_shapes, pos, weights, window):
    """Kernel B on CUDA tensors already checked."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    out = value.new_empty(B, Nq, h * d)
    levels, tiles, n_tiles, stage_floats, vec, lanes = _plan_args(
        value, spatial_shapes, window, out)
    _lib.call("msda_fwd", value.data_ptr(), levels, tiles, pos.data_ptr(),
              weights.data_ptr(), out.data_ptr(), B, S, Nq, h, d, L, P,
              n_tiles, stage_floats, vec, lanes)
    msda.launches += 1
    return out


def msda_backward(value, spatial_shapes, pos, weights, grad_out,
                  query_shapes=None, window_radius=None):
    """Kernel C: (d_value, d_pos, d_weights) of `msda` for the cotangent
    grad_out (B, Nq, heads·d), CUDA tensors only. `query_shapes` and
    `window_radius` as in `msda`. d_value is summed in an order that
    changes from run to run, and its low bits with it; d_pos and d_weights
    are deterministic."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    if tuple(grad_out.shape) != (B, Nq, h * d):
        raise ValueError(f"grad_out shape {tuple(grad_out.shape)} != "
                         f"{(B, Nq, h * d)}")
    window = _normalise_window(query_shapes, window_radius, Nq)
    _check_kernel_inputs(value, spatial_shapes, pos, weights, grad_out)
    d_value = torch.empty_like(value)      # zeroed by the C entry point
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)
    plan = _plan_args(value, spatial_shapes, window, grad_out, d_value)
    if shared_bytes_backward(plan[3], d, plan[5], P) > SM_SHARED_BYTES - 1024:
        # so many points that a tile's corner list outgrows an SM: no bins
        plan = _plan_args(value, spatial_shapes, (((1, Nq),), None),
                          grad_out, d_value)
    levels, tiles, n_tiles, stage_floats, vec, lanes = plan
    _lib.call("msda_bwd", value.data_ptr(), levels, tiles, pos.data_ptr(),
              weights.data_ptr(), grad_out.data_ptr(), d_value.data_ptr(),
              d_pos.data_ptr(), d_weights.data_ptr(), B, S, Nq, h, d, L, P,
              n_tiles, stage_floats, vec, lanes)
    msda_backward.launches += 1
    return d_value, d_pos, d_weights


def msda_backward_plain(value, spatial_shapes, pos, weights, grad_out):
    """Plain twin of `msda_backward`: autograd through `msda_plain`, one
    query chunk at a time. Queries are independent, so d_pos and d_weights
    come per chunk while d_value is summed over the chunks; autograd through
    the whole `msda_plain` would keep every chunk's gathered corners alive
    at once (~34 GB at the train crop's cross-attention)."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    d_value = torch.zeros_like(value)
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)
    v = value.detach().requires_grad_()
    for q0 in range(0, pos.shape[1], PLAIN_QUERY_CHUNK):
        q1 = q0 + PLAIN_QUERY_CHUNK
        p = pos[:, q0:q1].detach().requires_grad_()
        w = weights[:, q0:q1].detach().requires_grad_()
        with torch.enable_grad():
            out = msda_plain(v, spatial_shapes, p, w)
            gv, gp, gw = torch.autograd.grad(out, (v, p, w),
                                             grad_out[:, q0:q1])
        d_value += gv
        d_pos[:, q0:q1] = gp
        d_weights[:, q0:q1] = gw
    return d_value, d_pos, d_weights


class MSDAFunction(torch.autograd.Function):
    """Kernel B forward, kernel C backward. The tanh of the windowed rule,
    the anchor add and the weight softmax stay upstream in autograd.
    `window` is the (query_shapes, radius) pair of `_normalise_window`."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, pos, weights, window):
        ctx.spatial_shapes, ctx.window = spatial_shapes, window
        ctx.save_for_backward(value, pos, weights)
        return _launch_forward(value, spatial_shapes, pos, weights, window)

    @staticmethod
    def backward(ctx, grad_out):
        value, pos, weights = ctx.saved_tensors
        query_shapes, radius = ctx.window
        d_value, d_pos, d_weights = msda_backward(
            value, ctx.spatial_shapes, pos, weights, grad_out.contiguous(),
            None if radius is None else query_shapes, radius)
        return d_value, None, d_pos, d_weights, None


def msda(value, spatial_shapes, pos, weights, query_shapes=None,
         window_radius=None):
    """Deformable sampling over all levels; kernels B (forward) and C
    (backward) for CUDA tensors, the plain version for CPU tensors.

    `query_shapes` (the row-major query grids, concatenated) and
    `window_radius` tell the kernels that every sample lies within the
    radius, in level pixels, of its query's anchor, as
    `windowed_positions` forms them: the kernels then stage value windows
    in shared memory. They change no result: positions that leave the
    window, or a call without them, are sampled from device memory."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    window = _normalise_window(query_shapes, window_radius, pos.shape[1])
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, pos, weights)
    _check_kernel_inputs(value, spatial_shapes, pos, weights)
    return MSDAFunction.apply(value, spatial_shapes, pos, weights, window)


msda.launches = 0
msda_backward.launches = 0
