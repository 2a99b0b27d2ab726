"""Ground-embedding necks (the port of `gedepth_tpu.models.necks`).

Both fuse the five neck outputs [stem, s1..s4] at the stem resolution: a
3x3 conv per scale (conv0 on the coarsest ... conv4 on the stem, the
reference naming), upsampled with align_corners=True and summed.
LightPEMaskNeck then predicts the ground mask y (sigmoid);
DynamicPENeckSoft predicts the 11 slope-bin logits.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from gedepth_tpu_torch.models.layers import conv2d
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw


class _ScaleFuseNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 channels: int = 64):
        super().__init__()
        for i, c in enumerate(list(in_channels)[::-1]):
            self.add_module(f"conv{i}", conv2d(c, channels, 3, padding=1,
                                               init="xavier"))
        self.num_inputs = len(in_channels)
        self.convfinal = conv2d(channels, out_channels, 3, padding=1,
                                init="xavier")

    def fuse(self, inputs):
        target = inputs[0].shape[2:]
        fused = None
        for i, x in enumerate(inputs[::-1]):
            y = resize_bilinear_nchw(getattr(self, f"conv{i}")(x), target,
                                     align_corners=True)
            fused = y if fused is None else fused + y
        return fused


class LightPEMaskNeck(_ScaleFuseNeck):
    def __init__(self, in_channels, channels: int = 64):
        super().__init__(in_channels, 1, channels)

    def forward(self, inputs):
        """Returns (sigmoid ground mask (B, 1, H/2, W/2), fused feature)."""
        x = self.fuse(inputs)
        return torch.sigmoid(self.convfinal(x)), x


class DynamicPENeckSoft(_ScaleFuseNeck):
    def __init__(self, in_channels, channels: int = 64, num_bins: int = 11):
        super().__init__(in_channels, num_bins, channels)

    def forward(self, inputs):
        """Returns the slope-bin logits (B, 11, H/2, W/2)."""
        return self.convfinal(self.fuse(inputs))
