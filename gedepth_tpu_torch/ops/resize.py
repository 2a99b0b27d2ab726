"""Bilinear resize of NHWC tensors through `F.interpolate`.

`gedepth_tpu.ops.resize.resize_bilinear` was written to match
`F.interpolate(mode='bilinear')` for both corner conventions
(tests/test_resize.py), so the port calls it directly.
"""
from __future__ import annotations

import torch.nn.functional as F


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
