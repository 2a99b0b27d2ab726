"""EfficientNet backbones of the zoo's AdaBins (the port of
`gedepth_tpu.models.efficientnet`), NCHW.

`EfficientNet` ('b0'-'b3'): a stride-2 stem, the seven MBConv stages of
B0 scaled by width and depth, squeeze-excite from the block input's width,
swish; the outputs are the features before each stride-2 block whose
stride is an output stride, and the last block's, the last four kept
(/4, /8, /16, /32; 24, 40, 112, 320 channels at b0). Convs pad k//2 on
every side. Names: `stem.{conv,bn}`, `blocks.{stage}.{block}.{expand,dw,
project}.{conv,bn}`, `.se_reduce`, `.se_expand`.

`TimmEfficientNet` ('tf_b5'): timm's gen-efficientnet for the tf_
checkpoints, as the reference wraps it (`backbone.original_model`,
depth/models/backbones/efficientnet.py): TF 'SAME' padding computed from
the input size (the extra pixel at the bottom and right), a depthwise-
separable first stage, inverted-residual stages, the endpoints stage 0,
1, 2, 4 and the raw `conv_head` (/2 to /32; 24, 40, 64, 176, 2048 at b5).
Names follow timm's, under `original_model`, so a reference `.pth` loads
as is.

Every BatchNorm is the port's `BatchNorm2d` with eps 1e-3 and torch
momentum 0.1 (flax 0.9); swish is SiLU.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d

# (expand, channels, repeats, stride, kernel) per stage: B0
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# width, depth multipliers
SCALES = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
          "b3": (1.2, 1.4)}
# timm's scalings of the tf_ checkpoint family
TIMM_SCALES = {"tf_b5": (1.6, 2.2)}
OUT_STRIDES = (4, 8, 16, 32)
SE_RATIO = 0.25             # of the block input's width


def round_channels(c, mult, divisor=8):
    c = c * mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return int(new)


def _bn(channels):
    return BatchNorm2d(channels, eps=1e-3, momentum=0.1)


class ConvBNAct(nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = _bn(out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class MBConv(nn.Module):
    def __init__(self, in_ch, out_ch, expand, kernel, stride):
        super().__init__()
        mid = in_ch * expand
        self.expand = ConvBNAct(in_ch, mid, 1) if expand != 1 else None
        self.dw = ConvBNAct(mid, mid, kernel, stride, groups=mid)
        se = max(1, int(in_ch * SE_RATIO))
        self.se_reduce = conv2d(mid, se, 1)
        self.se_expand = conv2d(se, mid, 1)
        self.project = ConvBNAct(mid, out_ch, 1, act=False)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.dw(h)
        s = F.silu(self.se_reduce(h.mean(dim=(2, 3), keepdim=True)))
        h = self.project(h * torch.sigmoid(self.se_expand(s)))
        return h + x if self.residual else h


class EfficientNet(nn.Module):
    def __init__(self, arch: str = "b0"):
        super().__init__()
        wm, dm = SCALES[arch]
        stem = round_channels(32, wm)
        self.stem = ConvBNAct(3, stem, 3, 2)
        stages, taps, cin, stride = [], [], stem, 2
        self.channels = []
        for expand, ch, reps, s0, k in B0_STAGES:
            ch = round_channels(ch, wm)
            blocks = []
            for r in range(int(math.ceil(reps * dm))):
                s = s0 if r == 0 else 1
                if s == 2 and stride in OUT_STRIDES:
                    taps.append((len(stages), len(blocks)))
                    self.channels.append(cin)
                stride *= s
                blocks.append(MBConv(cin, ch, expand, k, s))
                cin = ch
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.channels = (self.channels + [cin])[-len(OUT_STRIDES):]
        self._taps = set(taps)

    def forward(self, x):
        """(B, 3, H, W) -> the last four taps, fine to coarse."""
        x = self.stem(x)
        outs = []
        for si, stage in enumerate(self.blocks):
            for r, block in enumerate(stage):
                if (si, r) in self._taps:
                    outs.append(x)
                x = block(x)
        outs.append(x)
        return outs[-len(OUT_STRIDES):]


def same_pads(size: int, k: int, s: int):
    """TF 'SAME' padding (before, after) of one axis: the extra pixel goes
    after."""
    pad = max(0, (-(-size // s) - 1) * s + k - size)
    return pad // 2, pad - pad // 2


class Conv2dSame(nn.Conv2d):
    """timm's Conv2dSame: TF 'SAME' padding from the input size."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1,
                 bias=False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_pads(n, k, s)
                                        for n in x.shape[2:])
        return self._conv_forward(F.pad(x, (left, right, top, bottom)),
                                  self.weight, self.bias)


class TimmSE(nn.Module):
    """Squeeze-excite reduced from the block input's width."""

    def __init__(self, mid, reduced):
        super().__init__()
        self.conv_reduce = conv2d(mid, reduced, 1)
        self.conv_expand = conv2d(reduced, mid, 1)

    def forward(self, h):
        s = F.silu(self.conv_reduce(h.mean(dim=(2, 3), keepdim=True)))
        return h * torch.sigmoid(self.conv_expand(s))


class TimmDSBlock(nn.Module):
    """Depthwise-separable block of stage 0: dw, SE, pw, no expansion."""

    def __init__(self, in_ch, out_ch, kernel, stride):
        super().__init__()
        self.conv_dw = Conv2dSame(in_ch, in_ch, kernel, stride, groups=in_ch)
        self.bn1 = _bn(in_ch)
        self.se = TimmSE(in_ch, max(1, int(in_ch * SE_RATIO)))
        self.conv_pw = Conv2dSame(in_ch, out_ch, 1)
        self.bn2 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.se(F.silu(self.bn1(self.conv_dw(x))))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class TimmIRBlock(nn.Module):
    """Inverted residual: pw expand, dw, SE, pw linear."""

    def __init__(self, in_ch, out_ch, expand, kernel, stride):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = Conv2dSame(in_ch, mid, 1)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, kernel, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = TimmSE(mid, max(1, int(in_ch * SE_RATIO)))
        self.conv_pwl = Conv2dSame(mid, out_ch, 1)
        self.bn3 = _bn(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class TimmBody(nn.Module):
    ENDPOINTS = (0, 1, 2, 4)

    def __init__(self, wm, dm):
        super().__init__()
        stem = round_channels(32, wm)
        self.conv_stem = Conv2dSame(3, stem, 3, 2)
        self.bn1 = _bn(stem)
        stages, cin, self.channels = [], stem, []
        for si, (expand, ch, reps, s0, k) in enumerate(B0_STAGES):
            ch = round_channels(ch, wm)
            blocks = []
            for r in range(int(math.ceil(reps * dm))):
                s = s0 if r == 0 else 1
                blocks.append(TimmDSBlock(cin, ch, k, s) if si == 0 else
                              TimmIRBlock(cin, ch, expand, k, s))
                cin = ch
            stages.append(nn.Sequential(*blocks))
            if si in self.ENDPOINTS:
                self.channels.append(ch)
        self.blocks = nn.ModuleList(stages)
        head = round_channels(1280, wm)
        self.conv_head = Conv2dSame(cin, head, 1)
        self.channels.append(head)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        outs = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in self.ENDPOINTS:
                outs.append(x)
        outs.append(self.conv_head(x))
        return outs


class TimmEfficientNet(nn.Module):
    def __init__(self, arch: str = "tf_b5"):
        super().__init__()
        self.original_model = TimmBody(*TIMM_SCALES[arch])
        self.channels = self.original_model.channels

    def forward(self, x):
        """(B, 3, H, W) -> five endpoints, /2 to /32."""
        return self.original_model(x)
