"""Swin window attention: softmax(q kᵀ + bias[h] + mask[w mod nW]) v.

`window_attention` is the hot op of the Swin backbone: batched attention over
N = window² tokens with a relative-position bias shared across windows and
an optional per-window additive shift mask. q arrives pre-scaled.

Shapes (the JAX package's layout):
  q, k, v  (nWB, N, heads, D)
  bias     (heads, N, N)
  mask     (nW, N, N) or None; windows are laid out (B, nH, nW) row-major,
           so row r uses mask[r % nW]
  returns  (nWB, N, heads, D)

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/window_attention.cu`; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from gedepth_tpu_torch.ops import _lib

# the kernel's shared-memory tiles hold at most this many tokens / channels
MAX_TOKENS = 64
MAX_HEAD_DIM = 64


def window_attention_plain(q, k, v, bias, mask=None):
    """Plain PyTorch version: the einsum of `window_attention_xla`."""
    nWB, N, H, D = q.shape
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(nWB // nW, nW, H, N, N) + \
            mask[None, :, None].to(attn.dtype)
        attn = attn.view(nWB, H, N, N)
    attn = attn.softmax(dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def _check(q, k, v, bias, mask):
    nWB, N, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(H, N, N)}")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N) \
                or nWB % mask.shape[0]:
            raise ValueError(f"mask shape {tuple(mask.shape)} does not tile "
                             f"{nWB} windows of {N} tokens")
    tensors = [q, k, v, bias] + ([] if mask is None else [mask])
    for t in tensors:
        if t.device != q.device:
            raise ValueError("window_attention: all inputs on one device")


def window_attention(q, k, v, bias, mask=None):
    """softmax(q kᵀ + bias + mask) v; the kernel for CUDA tensors."""
    _check(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {q.device}")
    nWB, N, H, D = q.shape
    if N > MAX_TOKENS or D > MAX_HEAD_DIM:
        raise ValueError(f"window_attention kernel takes N <= {MAX_TOKENS} "
                         f"and D <= {MAX_HEAD_DIM}, got N={N} D={D}")
    tensors = [q, k, v, bias] + ([] if mask is None else [mask])
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"window_attention kernel is f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("window_attention kernel needs contiguous "
                             "inputs")
    out = torch.empty_like(q)
    nW = 0 if mask is None else mask.shape[0]
    _lib.call("window_attention_fwd", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), bias.data_ptr(),
              None if mask is None else mask.data_ptr(), out.data_ptr(),
              nWB, N, H, D, nW)
    window_attention.launches += 1
    return out


window_attention.launches = 0
