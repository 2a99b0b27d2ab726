"""Bilinear resize of NHWC tensors through `F.interpolate`, and nearest
resize by JAX's index rule.

`gedepth_tpu.ops.resize.resize_bilinear` was written to match
`F.interpolate(mode='bilinear')` for both corner conventions
(tests/test_resize.py), so the port calls it directly. Its nearest rule
takes src = floor(o·in/out) in float64; `F.interpolate(mode='nearest')`
forms its scale in single precision and can pick another row at some
sizes, so `resize_nearest_nchw` gathers with the float64 index instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_index(in_size: int, out_size: int, device=None):
    """(out_size,) int64 source rows of a nearest resize: floor(o·in/out)
    in float64, clamped to in_size − 1 (the JAX package's rule)."""
    o = torch.arange(out_size, dtype=torch.float64, device=device)
    return torch.floor(o * (in_size / out_size)).long().clamp_(
        max=in_size - 1)


def resize_nearest_nchw(x, size):
    """Nearest-neighbour resize of an NCHW tensor to `size` = (out_h,
    out_w), by `nearest_index` on each axis."""
    (h, w), (oh, ow) = x.shape[-2:], (int(size[0]), int(size[1]))
    if h != oh:
        x = x.index_select(-2, nearest_index(h, oh, x.device))
    if w != ow:
        x = x.index_select(-1, nearest_index(w, ow, x.device))
    return x


def resize_bilinear_nchw(x, size, align_corners: bool = False):
    """Bilinearly resize an NCHW tensor to `size` = (out_h, out_w)."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear",
                         align_corners=align_corners)


def resize_bilinear(x, size, align_corners: bool = False):
    """Bilinearly resize an NHWC tensor to `size` = (out_h, out_w)."""
    if tuple(x.shape[1:3]) == (int(size[0]), int(size[1])):
        return x
    return resize_bilinear_nchw(x.permute(0, 3, 1, 2), size,
                                align_corners).permute(0, 2, 3, 1)
