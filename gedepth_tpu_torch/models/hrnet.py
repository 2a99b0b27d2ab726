"""HRNet backbone (the port of `gedepth_tpu.models.hrnet`): parallel
multi-resolution streams with repeated cross-resolution fusion (Wang et
al. 2019). A stem of two stride-2 3x3 convs (/4), stage 1 of Bottlenecks,
then three multi-branch stages of BasicBlock modules with full fusion;
forward returns the pyramid [/4, /8, /16, /32], NCHW.

Module names are mmcv's HRNet names, so a reference state dict loads as it
is: `conv1`/`bn1`, `conv2`/`bn2`, `layer1.{b}`, `transition{T}.{I}` (a
conv-BN-ReLU Sequential that adapts an existing branch, or a Sequential of
one such Sequential that makes a new branch; None where a branch passes
through), `stage{S}.{M}.branches.{I}.{B}` and `stage{S}.{M}.fuse_layers.
{I}.{J}` (coarse to fine: conv and BN, the nearest upsample done in
forward; fine to coarse: a chain of stride-2 conv-BN(-ReLU) Sequentials;
None on the diagonal). Transition T comes before stage T + 1.

The fuse layers' nearest upsample repeats each pixel ceil(target/size)
times and crops to the target (`upsample_nearest`), as the JAX package
does; at odd sizes that differs from `F.interpolate(size=...)`. Every conv
pads symmetrically by kernel // 2.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d
from gedepth_tpu_torch.models.resnet import BasicBlock, Bottleneck

# (num_modules, blocks per branch, channels per branch) of the stem stage
# and stages 2-4
HRNET_CFGS = {
    "w18": ((1, (4,), (64,)),
            (1, (4, 4), (18, 36)),
            (4, (4, 4, 4), (18, 36, 72)),
            (3, (4, 4, 4, 4), (18, 36, 72, 144))),
    "w32": ((1, (4,), (64,)),
            (1, (4, 4), (32, 64)),
            (4, (4, 4, 4), (32, 64, 128)),
            (3, (4, 4, 4, 4), (32, 64, 128, 256))),
    "w48": ((1, (4,), (64,)),
            (1, (4, 4), (48, 96)),
            (4, (4, 4, 4), (48, 96, 192)),
            (3, (4, 4, 4, 4), (48, 96, 192, 384))),
}


def upsample_nearest(x, size):
    """Nearest upsample of an NCHW tensor to `size` by repeating each pixel
    ceil(size / in) times along each axis, then cropping (the JAX
    package's `_upsample_nearest`)."""
    h, w = int(size[0]), int(size[1])
    x = x.repeat_interleave(-(-h // x.shape[2]), dim=2)
    x = x.repeat_interleave(-(-w // x.shape[3]), dim=3)
    return x[:, :, :h, :w]


def conv_bn(in_ch, out_ch, kernel, stride=1, relu=False):
    """Sequential(conv without bias, BatchNorm[, ReLU]): keys `0`, `1`."""
    mods = [conv2d(in_ch, out_ch, kernel, stride=stride,
                   padding=kernel // 2, bias=False), BatchNorm2d(out_ch)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class HRModule(nn.Module):
    """The branches (BasicBlocks) and the full fusion: output i sums every
    branch j, upsampled by a 1x1 conv-BN and `upsample_nearest` from
    coarser ones, downsampled by i − j stride-2 3x3 conv-BNs (ReLU between)
    from finer ones; ReLU after each sum."""

    def __init__(self, channels: Sequence[int], num_blocks: Sequence[int]):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(channels[i], channels[i])
                            for _ in range(num_blocks[i])])
            for i in range(n))
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(conv_bn(channels[j], channels[i], 1))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        conv_bn(channels[j],
                                channels[i] if k == i - j - 1
                                else channels[j], 3, stride=2,
                                relu=k < i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, (layer, y) in enumerate(zip(row, ys)):
                if j > i:
                    y = upsample_nearest(layer(y), ys[i].shape[2:])
                elif j < i:
                    y = layer(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """HRNet of `HRNET_CFGS[arch]` (or a config tuple of that form) on
    RGB NCHW input; forward -> [/4, /8, /16, /32]."""

    def __init__(self, arch="w18"):
        super().__init__()
        cfg = HRNET_CFGS[arch] if isinstance(arch, str) else arch
        self.conv1 = conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        planes1, cin, blocks = cfg[0][2][0], 64, []
        for b in range(cfg[0][1][0]):
            blocks.append(Bottleneck(cin, planes1,
                                     downsample=b == 0 and cin != planes1 * 4))
            cin = planes1 * 4
        self.layer1 = nn.Sequential(*blocks)
        prev = [cin]
        self.num_stages = len(cfg) - 1
        for s, (num_modules, num_blocks, channels) in enumerate(cfg[1:],
                                                                start=2):
            trans = []
            for i, ch in enumerate(channels):
                if i < len(prev):
                    trans.append(conv_bn(prev[i], ch, 3, relu=True)
                                 if prev[i] != ch else None)
                else:
                    trans.append(nn.Sequential(
                        conv_bn(prev[-1], ch, 3, stride=2, relu=True)))
            self.add_module(f"transition{s - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{s}", nn.Sequential(*[
                HRModule(channels, num_blocks) for _ in range(num_modules)]))
            prev = list(channels)
        self.channels = tuple(prev)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        branches = [self.layer1(x)]
        for s in range(2, 2 + self.num_stages):
            trans = getattr(self, f"transition{s - 1}")
            branches = [
                (branches[i] if layer is None else layer(branches[i]))
                if i < len(branches) else layer(branches[-1])
                for i, layer in enumerate(trans)]
            for module in getattr(self, f"stage{s}"):
                branches = module(branches)
        return branches
