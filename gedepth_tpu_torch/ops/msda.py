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

The sampling modes of `gedepth_tpu.ops.msda` differ only in how positions
are formed. `windowed_positions` is the windowed rule: each query's anchor
on the level (its grid centre, split into an integer anchor and a residual
from the float64 table of `gedepth_tpu.ops.msda._axis_anchor_residual`)
plus the bounded offset R·tanh(off/R).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from gedepth_tpu_torch.ops import _lib

# queries per step of the plain gather (bounds its temporaries)
PLAIN_QUERY_CHUNK = 4096
# channels per head the backward kernel takes (4 per lane of a warp)
MAX_BWD_HEAD_DIM = 128


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


def _check_kernel_inputs(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"msda: no kernel for {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"msda kernel is f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("msda kernel needs contiguous inputs")


def _launch_forward(value, spatial_shapes, pos, weights):
    """Kernel B on CUDA tensors already checked."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    levels = _level_table(spatial_shapes, value.device)
    out = value.new_empty(B, Nq, h * d)
    _lib.call("msda_fwd", value.data_ptr(), levels.data_ptr(),
              pos.data_ptr(), weights.data_ptr(), out.data_ptr(),
              B, S, Nq, h, d, L, P)
    msda.launches += 1
    return out


def msda_backward(value, spatial_shapes, pos, weights, grad_out):
    """Kernel C: (d_value, d_pos, d_weights) of `msda` for the cotangent
    grad_out (B, Nq, heads·d), CUDA tensors only. dV is summed with
    atomics, so its low bits vary from run to run."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    if tuple(grad_out.shape) != (B, Nq, h * d):
        raise ValueError(f"grad_out shape {tuple(grad_out.shape)} != "
                         f"{(B, Nq, h * d)}")
    _check_kernel_inputs(value, pos, weights, grad_out)
    if d > MAX_BWD_HEAD_DIM:
        raise ValueError(f"msda backward kernel takes d <= "
                         f"{MAX_BWD_HEAD_DIM}, got {d}")
    levels = _level_table(spatial_shapes, value.device)
    d_value = torch.empty_like(value)      # zeroed by the C entry point
    d_pos = torch.empty_like(pos)
    d_weights = torch.empty_like(weights)
    _lib.call("msda_bwd", value.data_ptr(), levels.data_ptr(),
              pos.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
              d_value.data_ptr(), d_pos.data_ptr(), d_weights.data_ptr(),
              B, S, Nq, h, d, L, P)
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
    the anchor add and the weight softmax stay upstream in autograd."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, pos, weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, pos, weights)
        return _launch_forward(value, spatial_shapes, pos, weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, pos, weights = ctx.saved_tensors
        d_value, d_pos, d_weights = msda_backward(
            value, ctx.spatial_shapes, pos, weights, grad_out.contiguous())
        return d_value, None, d_pos, d_weights


def msda(value, spatial_shapes, pos, weights):
    """Deformable sampling over all levels; kernels B (forward) and C
    (backward) for CUDA tensors, the plain version for CPU tensors."""
    spatial_shapes = tuple((int(H_), int(W_)) for (H_, W_) in spatial_shapes)
    _check(value, spatial_shapes, pos, weights)
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, pos, weights)
    _check_kernel_inputs(value, pos, weights)
    return MSDAFunction.apply(value, spatial_shapes, pos, weights)


msda.launches = 0
msda_backward.launches = 0
