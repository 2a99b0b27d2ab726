"""ResNet backbone (the port of `gedepth_tpu.models.resnet`): torchvision's
BasicBlock and Bottleneck in the 'pytorch' style (the stride on the 3x3),
NCHW, under the reference's mmseg module names: `conv1`, `bn1`,
`layer{i}.{b}.conv{1,2,3}`, `bn{1,2,3}` and `downsample.{0,1}`.

Every BatchNorm is the port's `BatchNorm2d` (momentum 0.1, eps 1e-5, the
global batch's statistics inside a process group). The max-pool pads with
−inf, as flax's `nn.max_pool` does.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d


def _conv(in_ch, out_ch, kernel, stride=1, dilation=1):
    return conv2d(in_ch, out_ch, kernel, stride=stride,
                  padding=dilation * (kernel // 2), bias=False,
                  dilation=dilation)


def _downsample(in_ch, out_ch, stride):
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride), BatchNorm2d(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """ResNet returning the pyramid [/4, /8, /16, /32] of `out_indices`,
    NCHW; include_stem=True puts the post-ReLU /2 stem (base_channels)
    first, the five levels the BTS and DenseDepth heads take (64, 256, 512,
    1024, 2048 for depth 50)."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 in_strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 base_channels: int = 64, include_stem: bool = False):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise ValueError(f"ResNet depth {depth} not in "
                             f"{sorted(ARCH_SETTINGS)}")
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.include_stem = include_stem
        self.conv1 = conv2d(in_channels, base_channels, 7, stride=2,
                            padding=3, bias=False)
        self.bn1 = BatchNorm2d(base_channels)
        inplanes, planes = base_channels, base_channels
        self.channels = [base_channels] if include_stem else []
        for i, n_blocks in enumerate(stage_blocks):
            blocks = []
            for b in range(n_blocks):
                stride = in_strides[i] if b == 0 else 1
                down = b == 0 and (stride != 1 or
                                   inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, stride, dilations[i],
                                    downsample=down))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            if i in self.out_indices:
                self.channels.append(inplanes)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        outs = [x] if self.include_stem else []
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
