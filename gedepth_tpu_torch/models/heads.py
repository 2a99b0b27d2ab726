"""DenseDepth decode head with ground-embedding fusion (the non-FPN branch
of `gedepth_tpu.models.heads`): an upsample-and-fuse chain from the deepest
neck scale to the stem scale, then
  depth = relu(conv_depth(x)) · (1 − y) + pe + min_depth
with pe and y resized to the head's resolution, or relu(conv_depth(x)) +
min_depth for a model without ground embedding. align_corners=True
throughout; LeakyReLU(0.01) in the upsample blocks (`UpSampleBlock` takes
another activation for AdaBins).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import ConvModule, conv2d, leaky_relu
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw


class UpSampleBlock(nn.Module):
    """upsample -> concat skip -> two 3x3 convs with `act`, no norm. act:
    LeakyReLU(0.01), as the GEDepth configs have it, or the toolbox's ReLU
    of AdaBins' `_base_` config."""

    def __init__(self, in_channels, skip_channels, features,
                 act=leaky_relu):
        super().__init__()
        self.convA = ConvModule(in_channels + skip_channels, features, 3,
                                act=act, use_bias=True)
        self.convB = ConvModule(features, features, 3, act=act,
                                use_bias=True)

    def forward(self, x, skip):
        x = resize_bilinear_nchw(x, skip.shape[2:], align_corners=True)
        return self.convB(self.convA(torch.cat([x, skip], dim=1)))


class DenseDepthHead(nn.Module):
    def __init__(self, up_sample_channels: Sequence[int] = (
            64, 192, 384, 768, 1536), channels: int = 64,
            min_depth: float = 1e-3):
        super().__init__()
        self.min_depth = min_depth
        up = list(up_sample_channels)[::-1]      # coarse -> fine
        blocks = [ConvModule(up[0], up[0], 1, use_bias=True)]
        for i in range(1, len(up)):
            blocks.append(UpSampleBlock(up[i - 1], up[i], up[i]))
        self.conv_list = nn.ModuleList(blocks)
        self.conv_depth = conv2d(up[-1], 1, 3, padding=1)

    def forward(self, inputs, pe_mask=None, y=None):
        """inputs [stem, s1..s4] NCHW fine -> coarse; pe_mask and y
        (B, 1, H, W), or None for both. Returns depth (B, 1, H/2, W/2)."""
        feats = inputs[::-1]
        x = self.conv_list[0](feats[0])
        for block, feat in zip(self.conv_list[1:], feats[1:]):
            x = block(x, feat)
        d = F.relu(self.conv_depth(x))
        if pe_mask is None:
            return d + self.min_depth
        pe = resize_bilinear_nchw(pe_mask, d.shape[2:], align_corners=True)
        y_r = resize_bilinear_nchw(y, d.shape[2:], align_corners=True)
        return d * (1.0 - y_r) + pe + self.min_depth
