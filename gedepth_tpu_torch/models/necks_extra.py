"""The reference's experiment necks (the port of
`gedepth_tpu.models.necks_extra`; depth/models/necks/{pemask_neck,
dynamicpe_neck,skip_neck}.py): no preset builds them, as in the JAX
package. They take and return NCHW tensors (pyramid lists fine to coarse)
and reuse the port's `heads.UpSampleBlock`, `necks.ScaleFuse` and
`layers.ConvModule`.

A neck's width arguments are the JAX module's; where flax infers an input
width from the first call, the port takes it as an argument (`in_channels`,
`stem_channels`), which defaults to the reference's pyramid. Module names
are the flax modules' (`chain.conv0`, `chain.up{i}.convA`, `fuse.conv{i}`,
`increase{i}`, `down{i}`, ...), each ConvModule with `conv` and `bn`.
Initialisation is the JAX package's: the 3x3 heads xavier with zero bias,
the Dense layers lecun-normal with zero bias, the rest PyTorch's default.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.heads import UpSampleBlock
from gedepth_tpu_torch.models.layers import (
    ConvModule, conv2d, leaky_relu, linear)
from gedepth_tpu_torch.models.necks import DynamicPENeckSoft, ScaleFuse
from gedepth_tpu_torch.models.resnet import Bottleneck
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw

PYRAMID = (64, 192, 384, 768, 1536)
HRNET_W18 = (18, 36, 72, 144)


def _conv3(in_ch, out_ch):
    return conv2d(in_ch, out_ch, 3, padding=1, init="xavier")


def _relu_cbr(in_ch, out_ch, kernel=3, stride=1):
    return ConvModule(in_ch, out_ch, kernel, stride=stride, use_norm=True,
                      act=F.relu)


class UpSampleChain(nn.Module):
    """DenseDepth's decoder chain: a biased 1x1 conv on the coarsest input,
    then an `UpSampleBlock` per finer input (LeakyReLU 0.01). Returns the
    finest level's up_sample_channels[0]-wide feature."""

    def __init__(self, up_sample_channels: Sequence[int] = PYRAMID,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        up = list(up_sample_channels)[::-1]
        ins = list(in_channels or up_sample_channels)[::-1]
        self.conv0 = ConvModule(ins[0], up[0], 1, use_bias=True)
        for i in range(1, len(up)):
            self.add_module(f"up{i}", UpSampleBlock(up[i - 1], ins[i],
                                                    up[i]))
        self.levels = len(up)

    def forward(self, inputs):
        feats = inputs[::-1]
        x = self.conv0(feats[0])
        for i in range(1, self.levels):
            x = getattr(self, f"up{i}")(x, feats[i])
        return x


class PEMaskNeck(nn.Module):
    """Heavy mask decoder: the chain, then a sigmoid 3x3 conv
    (pemask_neck.py:67-127). Returns (mask (B, 1, H, W), None)."""

    def __init__(self, up_sample_channels: Sequence[int] = PYRAMID,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.chain = UpSampleChain(up_sample_channels, in_channels)
        self.conv1 = _conv3(up_sample_channels[0], 1)

    def forward(self, inputs):
        return torch.sigmoid(self.conv1(self.chain(inputs))), None


class DynamicPEMaskNeck(nn.Module):
    """Heavy mask and slope-bin decoder (pemask_neck.py:172-232). Returns
    (mask (B, 1, H, W), bin logits (B, num_bins, H, W))."""

    def __init__(self, up_sample_channels: Sequence[int] = PYRAMID,
                 num_bins: int = 11,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.chain = UpSampleChain(up_sample_channels, in_channels)
        self.conv1 = _conv3(up_sample_channels[0], 1)
        self.conv2 = _conv3(up_sample_channels[0], num_bins)

    def forward(self, inputs):
        x = self.chain(inputs)
        return torch.sigmoid(self.conv1(x)), self.conv2(x)


class LightDynamicPEMaskNeck(nn.Module):
    """Light mask and slope-bin heads over the shared 5-scale fusion
    (pemask_neck.py:130-166)."""

    def __init__(self, in_channels: Sequence[int] = PYRAMID,
                 channels: int = 64, num_bins: int = 11):
        super().__init__()
        self.fuse = ScaleFuse(in_channels, channels)
        self.convfinal_attn = _conv3(channels, 1)
        self.convfinal_dynamic = _conv3(channels, num_bins)

    def forward(self, inputs):
        x = self.fuse(inputs)
        return (torch.sigmoid(self.convfinal_attn(x)),
                self.convfinal_dynamic(x))


class DynamicPENeckGlobal(nn.Module):
    """One slope distribution an image (dynamicpe_neck.py:79-170): the
    fusion pooled to a vector, Dense, LeakyReLU(0.01), Dense to the bins.
    Returns (B, num_bins)."""

    def __init__(self, in_channels: Sequence[int] = PYRAMID,
                 channels: int = 64, num_bins: int = 11):
        super().__init__()
        self.fuse = ScaleFuse(in_channels, channels)
        self.fc1 = linear(channels, channels, init="lecun")
        self.fc2 = linear(channels, num_bins, init="lecun")

    def forward(self, inputs):
        x = self.fuse(inputs).mean(dim=(2, 3))
        return self.fc2(leaky_relu(self.fc1(x)))


class DynamicPENeckStem(nn.Module):
    """One slope an image over the whole pyramid (dynamicpe_neck.py:148-
    249): a 1x1 `increase` on the stem, a stride-2 cascade that adds each
    level (its width must be widths[i + 1]), a 1x1 to final_channels, the
    mean over the pixels, a Dense to 1 and tanh. Returns (B, 1) in
    [−1, 1]."""

    def __init__(self, widths: Sequence[int] = (96, 192, 384, 768, 1536),
                 final_channels: int = 2048, stem_channels: int = 64):
        super().__init__()
        self.increase = _relu_cbr(stem_channels, widths[0], 1)
        for i in range(len(widths) - 1):
            self.add_module(f"down{i}", _relu_cbr(widths[i], widths[i + 1],
                                                  3, stride=2))
        self.final = _relu_cbr(widths[-1], final_channels, 1)
        self.mlp = linear(final_channels, 1, init="lecun")
        self.steps = len(widths) - 1

    def forward(self, inputs):
        x = self.increase(inputs[0])
        for i in range(self.steps):
            x = getattr(self, f"down{i}")(x) + inputs[i + 1]
        x = self.final(x).mean(dim=(2, 3))
        return torch.tanh(self.mlp(x))


class DynamicAttnPENeck(nn.Module):
    """Slope-bin logits an image from the stem: two stride-2 3x3
    conv-BN-ReLUs (128, 64), a 1x1 to out_channels, the max over the
    pixels (dynamicpe_neck.py:80-145). Returns (B, out_channels)."""

    def __init__(self, out_channels: int = 5, stem_channels: int = 64):
        super().__init__()
        self.down0 = _relu_cbr(stem_channels, 128, 3, stride=2)
        self.down1 = _relu_cbr(128, 64, 3, stride=2)
        self.final = _relu_cbr(64, out_channels, 1)

    def forward(self, stem_feat):
        x = self.final(self.down1(self.down0(stem_feat)))
        return x.amax(dim=(2, 3))


class DynamicPENeckBackbone(nn.Module):
    """Nine slope bins an image over an HRNet pyramid
    (dynamicpe_neck.py:251-317): a Bottleneck per level up to out_widths
    (a 1x1 downsample on each), a stride-2 cascade with adds, a 1x1 to
    final_channels, the mean over the pixels, a Dense to the bins. Returns
    (B, num_bins)."""

    def __init__(self, in_widths: Sequence[int] = HRNET_W18,
                 out_widths: Sequence[int] = (128, 256, 512, 1024),
                 final_channels: int = 2048, num_bins: int = 9):
        super().__init__()
        for i, (cin, c) in enumerate(zip(in_widths, out_widths)):
            self.add_module(f"increase{i}",
                            Bottleneck(cin, c // 4, downsample=True))
        for i in range(len(out_widths) - 1):
            self.add_module(f"down{i}", _relu_cbr(
                out_widths[i], out_widths[i + 1], 3, stride=2))
        self.final = _relu_cbr(out_widths[-1], final_channels, 1)
        self.fc = linear(final_channels, num_bins, init="lecun")
        self.levels = len(out_widths)

    def forward(self, inputs):
        incs = [getattr(self, f"increase{i}")(x)
                for i, x in enumerate(inputs[:self.levels])]
        feat = incs[0]
        for i in range(self.levels - 1):
            feat = getattr(self, f"down{i}")(feat) + incs[i + 1]
        return self.fc(self.final(feat).mean(dim=(2, 3)))


class DynamicPENeckSoft2(DynamicPENeckSoft):
    """Per-pixel slope bins over detached features, so the slope head
    trains without a gradient into the trunk (dynamicpe_neck.py:318-355
    DynamicPENeckSOFT2): the fusion and head of `DynamicPENeckSoft`."""

    def forward(self, inputs):
        return super().forward([x.detach() for x in inputs])


class DynamicPENeckSoftHRNet(DynamicPENeckSoft):
    """The soft slope head over HRNet's four levels, 18 wide
    (dynamicpe_neck.py:357-393)."""

    def __init__(self, in_channels: Sequence[int] = HRNET_W18,
                 channels: int = 18, num_bins: int = 11):
        super().__init__(in_channels, channels, num_bins)


class DynamicPENeckSoftDDR(nn.Module):
    """The soft slope head over DDRNet's single /8 map
    (dynamicpe_neck.py:395-428): two 3x3 conv-BN-ReLUs and a 1x1 conv to
    the bins (xavier, zero bias)."""

    def __init__(self, in_channels: int = 256, channels: int = 256,
                 num_bins: int = 11):
        super().__init__()
        self.fuse0 = _relu_cbr(in_channels, channels)
        self.fuse1 = _relu_cbr(channels, channels)
        self.out = conv2d(channels, num_bins, 1, init="xavier")

    def forward(self, x):
        return self.out(self.fuse1(self.fuse0(x)))


class DynamicPENeckHeavy(nn.Module):
    """The chain, then a 3x3 conv to the slope bins
    (dynamicpe_neck.py:430-488 DYNAMICPENeckHeavy)."""

    def __init__(self, up_sample_channels: Sequence[int] = PYRAMID,
                 num_bins: int = 11,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.chain = UpSampleChain(up_sample_channels, in_channels)
        self.conv1 = _conv3(up_sample_channels[0], num_bins)

    def forward(self, inputs):
        return self.conv1(self.chain(inputs))


class SkipNeck(nn.Module):
    """Passes the pyramid through, or resizes level i bilinearly by
    scales[i] (to int(h·s) x int(w·s); skip_neck.py:9)."""

    def __init__(self, scales: Optional[Sequence[float]] = None):
        super().__init__()
        self.scales = scales

    def forward(self, inputs):
        if not self.scales:
            return list(inputs)
        return [x if s == 1 else resize_bilinear_nchw(
                    x, (int(x.shape[2] * s), int(x.shape[3] * s)))
                for x, s in zip(inputs, self.scales)]
