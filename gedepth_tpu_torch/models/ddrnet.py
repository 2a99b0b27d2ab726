"""DDRNet, the dual-resolution backbone (the port of
`gedepth_tpu.models.ddrnet`; the reference's DualResNet,
depth/models/backbones/ddrnet.py): a biased stride-2 3x3 double stem, a
BasicBlock trunk whose last block of a layer returns its sum before the
ReLU (no_relu), a /8 high-resolution branch split off after layer2 and
fused with the low-resolution branch at three points (compression: 1x1
down the channels and bilinear up; down: stride-2 3x3 convs), expansion-2
Bottleneck caps on both branches, DAPPM on the /64 map, and `out_conv` on
the /8 sum. forward(x NCHW) -> the single /8 map (out_planes channels).

Module names are the reference's, so its state dict loads as it is:
`conv1.{0,1,3,4}` (the stem Sequential), `layer1`, `layer2`, `layer3_1`,
`layer3_2`, `layer4`, `layer5` and the high-resolution `layer3_1_`,
`layer3_2_`, `layer4_`, `layer5_` (blocks `conv{n}`/`bn{n}`,
`downsample.{0,1}`), `compression3_1`, `compression3_2`, `compression4`,
`down3_1`, `down3_2` and `out_conv` (conv at 0, BN at 1), `down4.{0,1,3,4}`
and `spp.{scale0-4, process1-4, compression, shortcut}` (pre-activation
BN -> ReLU -> conv Sequentials, a pooling first in scale1-4). Bilinear
resizes are align_corners=False; the average pools count their padding.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d
from gedepth_tpu_torch.models.resnet import _conv, _downsample
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw


class BasicBlock(nn.Module):
    """ddrnet.py's BasicBlock: conv-BN-ReLU, conv-BN, + the identity (or
    a 1x1 conv-BN downsample); ReLU unless no_relu."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 no_relu=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)
        self.no_relu = no_relu

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        return out if self.no_relu else F.relu(out)


class Bottleneck(nn.Module):
    """ddrnet.py's Bottleneck: expansion 2 (not torchvision's 4), no_relu
    by default."""
    expansion = 2

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 no_relu=True):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 2, 1)
        self.bn3 = BatchNorm2d(planes * 2)
        self.downsample = (_downsample(inplanes, planes * 2, stride)
                           if downsample else None)
        self.no_relu = no_relu

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        out = out + (x if self.downsample is None else self.downsample(x))
        return out if self.no_relu else F.relu(out)


def make_layer(block, inplanes, planes, blocks, stride=1):
    """ddrnet.py's _make_layer: the stride and a downsample on block 0
    when the stride or the width changes; with more than one block, the
    last has no_relu and the others not (a single block keeps its class's
    default)."""
    layers = []
    for b in range(blocks):
        kw = {"no_relu": b == blocks - 1} if blocks > 1 else {}
        down = b == 0 and (stride != 1
                           or inplanes != planes * block.expansion)
        layers.append(block(inplanes, planes, stride if b == 0 else 1,
                            downsample=down, **kw))
        inplanes = planes * block.expansion
    return nn.Sequential(*layers)


def _conv_bn(in_ch, out_ch, kernel, stride=1):
    return nn.Sequential(_conv(in_ch, out_ch, kernel, stride),
                         BatchNorm2d(out_ch))


def _bn_conv(in_ch, out_ch, kernel=1, pool=None):
    """Pre-activation BN -> ReLU -> conv, after `pool` when given."""
    mods = [] if pool is None else [pool]
    mods += [BatchNorm2d(in_ch), nn.ReLU(),
             _conv(in_ch, out_ch, kernel)]
    return nn.Sequential(*mods)


class DAPPM(nn.Module):
    """Deep aggregation pyramid pooling: pre-activation 1x1 branches over
    the map, its 5/2, 9/4 and 17/8 average pools and its global mean; each
    coarser branch upsampled and added to the previous branch's output
    before a 3x3 `process` conv; the five concatenated through a 1x1
    `compression`, plus a 1x1 `shortcut` of the input."""

    def __init__(self, in_ch, branch_planes, out_planes):
        super().__init__()
        self.scale1 = _bn_conv(in_ch, branch_planes,
                               pool=nn.AvgPool2d(5, 2, 2))
        self.scale2 = _bn_conv(in_ch, branch_planes,
                               pool=nn.AvgPool2d(9, 4, 4))
        self.scale3 = _bn_conv(in_ch, branch_planes,
                               pool=nn.AvgPool2d(17, 8, 8))
        self.scale4 = _bn_conv(in_ch, branch_planes,
                               pool=nn.AdaptiveAvgPool2d((1, 1)))
        self.scale0 = _bn_conv(in_ch, branch_planes)
        for i in range(1, 5):
            self.add_module(f"process{i}",
                            _bn_conv(branch_planes, branch_planes, 3))
        self.compression = _bn_conv(5 * branch_planes, out_planes)
        self.shortcut = _bn_conv(in_ch, out_planes)

    def forward(self, x):
        size = x.shape[2:]
        feats = [self.scale0(x)]
        for i in range(1, 5):
            s = resize_bilinear_nchw(getattr(self, f"scale{i}")(x), size)
            feats.append(getattr(self, f"process{i}")(s + feats[-1]))
        return self.compression(torch.cat(feats, 1)) + self.shortcut(x)


class DualResNet(nn.Module):
    """The reference's DualResNet; `layers` are the BasicBlock counts
    (DDRNet-23-slim (2, 2, 4, 2)), layer3 split into two halves around the
    first fusion. forward(x (B, 3, H, W)) -> (B, out_planes, H // 8,
    W // 8)."""

    def __init__(self, layers=(2, 2, 4, 2), planes: int = 32,
                 spp_planes: int = 128, out_planes: int = 256):
        super().__init__()
        p, hp, half = planes, 2 * planes, layers[2] // 2
        self.conv1 = nn.Sequential(
            conv2d(3, p, 3, stride=2, padding=1),
            BatchNorm2d(p), nn.ReLU(),
            conv2d(p, p, 3, stride=2, padding=1), BatchNorm2d(p), nn.ReLU())
        self.layer1 = make_layer(BasicBlock, p, p, layers[0])
        self.layer2 = make_layer(BasicBlock, p, 2 * p, layers[1], 2)
        self.layer3_1 = make_layer(BasicBlock, 2 * p, 4 * p, half, 2)
        self.layer3_2 = make_layer(BasicBlock, 4 * p, 4 * p, half)
        self.layer4 = make_layer(BasicBlock, 4 * p, 8 * p, layers[3], 2)
        self.compression3_1 = _conv_bn(4 * p, hp, 1)
        self.compression3_2 = _conv_bn(4 * p, hp, 1)
        self.compression4 = _conv_bn(8 * p, hp, 1)
        self.down3_1 = _conv_bn(hp, 4 * p, 3, 2)
        self.down3_2 = _conv_bn(hp, 4 * p, 3, 2)
        self.down4 = nn.Sequential(
            _conv(hp, 4 * p, 3, 2), BatchNorm2d(4 * p), nn.ReLU(),
            _conv(4 * p, 8 * p, 3, 2), BatchNorm2d(8 * p))
        self.layer3_1_ = make_layer(BasicBlock, 2 * p, hp, half)
        self.layer3_2_ = make_layer(BasicBlock, hp, hp, half)
        self.layer4_ = make_layer(BasicBlock, hp, hp, layers[3])
        self.layer5_ = make_layer(Bottleneck, hp, hp, 1)
        self.layer5 = make_layer(Bottleneck, 8 * p, 8 * p, 1, 2)
        self.spp = DAPPM(16 * p, spp_planes, 4 * p)
        self.out_conv = _conv_bn(4 * p, out_planes, 1)

    def init_params(self, gen):
        # the stem's biases start at zero, as the JAX package's
        nn.init.zeros_(self.conv1[0].bias)
        nn.init.zeros_(self.conv1[3].bias)

    def forward(self, x):
        h8 = (x.shape[2] // 8, x.shape[3] // 8)
        x = self.conv1(x)
        x = self.layer1(x)
        l2 = x = self.layer2(F.relu(x))
        l3_1 = x = self.layer3_1(F.relu(x))
        xh = self.layer3_1_(F.relu(l2))
        x = x + self.down3_1(F.relu(xh))
        xh = xh + resize_bilinear_nchw(self.compression3_1(F.relu(l3_1)), h8)
        l3_2 = x = self.layer3_2(F.relu(x))
        xh = self.layer3_2_(F.relu(xh))
        x = x + self.down3_2(F.relu(xh))
        xh = xh + resize_bilinear_nchw(self.compression3_2(F.relu(l3_2)), h8)
        l4 = x = self.layer4(F.relu(x))
        xh = self.layer4_(F.relu(xh))
        x = x + self.down4(F.relu(xh))
        xh = xh + resize_bilinear_nchw(self.compression4(F.relu(l4)), h8)
        xh = self.layer5_(F.relu(xh))
        x = resize_bilinear_nchw(self.spp(self.layer5(F.relu(x))), h8)
        return F.relu(self.out_conv(x + xh))
