"""DPT decode head (the port of `gedepth_tpu.models.dpt`; Ranftl et al.
2021), NCHW, under the reference's module names
(depth/models/decode_heads/dpt_head.py), so a reference `.pth` loads as is:

  reassemble_blocks.readout_projects.{i}.0   Linear(2C, C), then tanh GELU
  reassemble_blocks.projects.{i}.conv        1x1 conv to the scale's width
  reassemble_blocks.resize_layers.{i}        4x and 2x transposed convs
                                             (k = stride), identity, a
                                             stride-2 3x3 conv
  convs.{i}.conv                             3x3 conv to `channels`, no bias
  fusion_blocks.{j}                          fusion, deepest first:
                                             res_conv_unit{1,2}.conv{1,2}
                                             .conv (no bias), project.conv
  project.conv, conv_depth.head.{0,2,4}      the head's convs

The readout GELU is the tanh approximation (flax `nn.gelu`'s default); the
ViT's FFN takes the exact one. Bilinear resizes between the fusion stages
and in the head take align_corners=True. Output relu(d) + min_depth at the
input's resolution (twice the /2 fusion output).

`Deconv` is the JAX `_Deconv` (Dense + depth-to-space) as a transposed
conv: its weight is torch's (C_in, C_out, k, k); its bias is one value per
output channel and sub-pixel, (C_out, k, k), as the Dense bias of the JAX
package has it. A reference `.pth` gives one per channel
(`convert.from_pth` spreads it over the sub-pixels).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import conv2d, linear
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw

SCALES = (4, 2, 1, 0.5)


class Deconv(nn.Module):
    """Transposed conv with kernel = stride = `factor`."""

    def __init__(self, in_ch: int, out_ch: int, factor: int):
        super().__init__()
        self.factor = factor
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, factor, factor))
        self.bias = nn.Parameter(torch.zeros(out_ch, factor, factor))

    def init_params(self, gen):
        # flax Dense's default: lecun normal over the input features
        std = self.weight.shape[0] ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight, stride=self.factor)
        h, w = x.shape[2:]
        return y + self.bias.repeat(1, h, w)


class _Conv(nn.Module):
    """A conv under the attribute `conv` (mmcv ConvModule without norm or
    activation)."""

    def __init__(self, in_ch, out_ch, kernel, bias=True, stride=1):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, kernel, stride=stride,
                           padding=kernel // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


class ReassembleBlocks(nn.Module):
    """Tokens of four ViT layers to four maps at /4, /8, /16 and /32: the
    'project' readout (the class token concatenated to every token, then a
    Linear back to C and GELU), a 1x1 conv, the learned resize."""

    def __init__(self, in_channels: int, out_channels: Sequence[int]):
        super().__init__()
        self.readout_projects = nn.ModuleList(
            nn.Sequential(linear(2 * in_channels, in_channels, init="lecun"),
                          nn.GELU(approximate="tanh"))
            for _ in out_channels)
        self.projects = nn.ModuleList(_Conv(in_channels, c, 1)
                                      for c in out_channels)
        resize = []
        for c, s in zip(out_channels, SCALES):
            if s >= 2:
                resize.append(Deconv(c, c, int(s)))
            elif s == 1:
                resize.append(nn.Identity())
            else:
                resize.append(conv2d(c, c, 3, stride=2, padding=1))
        self.resize_layers = nn.ModuleList(resize)

    def forward(self, inputs):
        out = []
        for i, (tokens, (h, w)) in enumerate(inputs):
            grid = tokens[:, 1:]
            x = torch.cat([grid, tokens[:, :1].expand_as(grid)], dim=-1)
            x = self.readout_projects[i](x)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
            out.append(self.resize_layers[i](self.projects[i](x)))
        return out


class ResidualConvUnit(nn.Module):
    """Pre-activation residual unit of two bias-free 3x3 convs."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = _Conv(channels, channels, 3, bias=False)
        self.conv2 = _Conv(channels, channels, 3, bias=False)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """(x + rcu1(skip)), rcu2, 2x bilinear upsample, 1x1 conv. The deepest
    block takes no skip and has no rcu1."""

    def __init__(self, channels: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res_conv_unit1 = ResidualConvUnit(channels)
        self.res_conv_unit2 = ResidualConvUnit(channels)
        self.project = _Conv(channels, channels, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.res_conv_unit1(skip)
        x = self.res_conv_unit2(x)
        x = resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2),
                                 align_corners=True)
        return self.project(x)


class Upsample2x(nn.Module):
    def forward(self, x):
        return resize_bilinear_nchw(x, (x.shape[2] * 2, x.shape[3] * 2),
                                    align_corners=True)


class HeadDepth(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.head = nn.Sequential(
            conv2d(channels, channels // 2, 3, padding=1), Upsample2x(),
            conv2d(channels // 2, 32, 3, padding=1), nn.ReLU(),
            conv2d(32, 1, 1))

    def forward(self, x):
        return self.head(x)


class DPTHead(nn.Module):
    def __init__(self, embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 channels: int = 256, min_depth: float = 1e-3):
        super().__init__()
        self.min_depth = min_depth
        self.reassemble_blocks = ReassembleBlocks(embed_dims,
                                                  post_process_channels)
        self.convs = nn.ModuleList(_Conv(c, channels, 3, bias=False)
                                   for c in post_process_channels)
        self.fusion_blocks = nn.ModuleList(
            FeatureFusionBlock(channels, with_skip=j > 0) for j in range(4))
        self.project = _Conv(channels, channels, 3)
        self.conv_depth = HeadDepth(channels)

    def forward(self, inputs):
        """inputs: [(tokens, (h, w))] of four ViT blocks, shallow to deep.
        Returns depth (B, 1, H, W)."""
        maps = [conv(x) for conv, x in zip(
            self.convs, self.reassemble_blocks(inputs))]
        x = self.fusion_blocks[0](maps[3])
        for j, skip in zip((1, 2, 3), (maps[2], maps[1], maps[0])):
            x = resize_bilinear_nchw(x, skip.shape[2:], align_corners=True)
            x = self.fusion_blocks[j](x, skip)
        x = F.relu(self.project(x))
        return F.relu(self.conv_depth(x)) + self.min_depth
