"""BTS decode head, multi-scale local planar guidance (the port of
`gedepth_tpu.models.bts`; Lee et al. 2019), NCHW, under the reference's
module names (depth/models/decode_heads/bts_head.py): `upconv{n}.conv`,
`bn{n}`, `bn4_2`, `conv{n}.0`, `daspp_{d}.atrous_conv.first_bn` and
`.aconv_sequence.{1,2,4}`, `daspp_conv.0`, `reduc{r}.reduc.inter_{in}_{out}.0`
/ `plane_params` / `final.0`, and `conv_depth`.

Every BatchNorm takes torch momentum 0.01 and eps 1.1e-5 (flax momentum
0.99). Nearest resizes follow the JAX index rule (`ops.resize.
resize_nearest_nchw`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import BatchNorm2d, conv2d
from gedepth_tpu_torch.ops.resize import resize_nearest_nchw


def _bn(num_features):
    return BatchNorm2d(num_features, eps=1.1e-5, momentum=0.01)


def _conv_elu(in_ch, out_ch):
    """3x3 conv without bias, then ELU, as `Sequential` entries 0 and 1."""
    return nn.Sequential(conv2d(in_ch, out_ch, 3, padding=1, bias=False),
                         nn.ELU())


class UpConv(nn.Module):
    """Nearest upsample by `ratio`, 3x3 conv without bias, ELU."""

    def __init__(self, in_ch, out_ch, ratio=2):
        super().__init__()
        self.ratio = ratio
        self.conv = conv2d(in_ch, out_ch, 3, padding=1, bias=False)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = resize_nearest_nchw(x, (h * self.ratio, w * self.ratio))
        return F.elu(self.conv(x))


class AtrousConv(nn.Module):
    """(BN) -> ReLU -> 1x1 conv -> BN -> ReLU -> dilated 3x3 conv; the
    leading ReLU applies also without the first BN (bts_head.py:18-22)."""

    def __init__(self, in_ch, out_ch, dilation, apply_bn_first=True):
        super().__init__()
        self.atrous_conv = nn.Sequential()
        if apply_bn_first:
            self.atrous_conv.add_module("first_bn", _bn(in_ch))
        self.atrous_conv.add_module("aconv_sequence", nn.Sequential(
            nn.ReLU(),
            conv2d(in_ch, out_ch * 2, 1, bias=False),
            _bn(out_ch * 2),
            nn.ReLU(),
            conv2d(out_ch * 2, out_ch, 3, padding=dilation, bias=False,
                   dilation=dilation)))

    def forward(self, x):
        return self.atrous_conv(x)


class Reduction1x1(nn.Module):
    """1x1 conv + ELU chain halving the filters down to fewer than 8, then
    the plane parameters (theta, phi, dist) as a unit normal and a
    distance (B, 4, h, w), or with is_final a sigmoid depth fraction
    (B, 1, h, w)."""

    def __init__(self, in_ch, num_out_filters, max_depth, is_final=False):
        super().__init__()
        self.max_depth = max_depth
        self.reduc = nn.Sequential()
        n_out = num_out_filters
        while n_out >= 4:
            if n_out < 8:
                if is_final:
                    self.reduc.add_module("final", nn.Sequential(
                        conv2d(in_ch, 1, 1, bias=False), nn.Sigmoid()))
                else:
                    self.reduc.add_module(
                        "plane_params", conv2d(in_ch, 3, 1, bias=False))
                break
            self.reduc.add_module(f"inter_{in_ch}_{n_out}", nn.Sequential(
                conv2d(in_ch, n_out, 1, bias=False), nn.ELU()))
            in_ch, n_out = n_out, n_out // 2

    def forward(self, x):
        x = self.reduc(x)
        if hasattr(self.reduc, "final"):
            return x
        # under 4 filters (a head of num_features < 128) no conv runs and x
        # keeps its channels, and the plane parameters read channels 0-2 as
        # the JAX head does, an index past the last clamped to it (JAX's
        # backward drops that read's gradient, this one keeps it)
        c = x.shape[1]
        t, p, d = (x[:, min(i, c - 1)] for i in range(3))
        theta = torch.sigmoid(t) * (math.pi / 3)
        phi = torch.sigmoid(p) * (math.pi * 2)
        dist = torch.sigmoid(d) * self.max_depth
        return torch.stack([torch.sin(theta) * torch.cos(phi),
                            torch.sin(theta) * torch.sin(phi),
                            torch.cos(theta), dist], dim=1)


def local_planar_guidance(plane_eq, upratio: int):
    """(B, 4, h, w) plane parameters -> (B, h·r, w·r) depth: each pixel's
    plane intersected with the ray through its sub-pixel offset
    (bts_head.py:83-105)."""
    r = upratio
    exp = plane_eq.repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)
    n1, n2, n3, n4 = exp.unbind(1)
    _, _, h, w = plane_eq.shape
    u = (torch.arange(r, dtype=torch.float32, device=plane_eq.device)
         - (r - 1) * 0.5) / r
    u_full = u.repeat(w)[None, None, :]
    v_full = u.repeat(h)[None, :, None]
    return n4 / (n1 * u_full + n2 * v_full + n3)


class BTSHead(nn.Module):
    """Inputs: the 5-level pyramid [/2, /4, /8, /16, /32] NCHW; returns
    depth (B, 1, H, W) at the input's resolution. `focal` (B,) is read only
    with final_norm (KITTI-style)."""

    def __init__(self, in_channels: Sequence[int] = (64, 256, 512, 1024,
                                                     2048),
                 num_features: int = 512, max_depth: float = 10.0,
                 min_depth: float = 1e-3, final_norm: bool = False,
                 scale_up: bool = False):
        super().__init__()
        c0, c1, c2, c3, c4 = in_channels
        nf = num_features
        self.max_depth, self.min_depth = max_depth, min_depth
        self.final_norm, self.scale_up = final_norm, scale_up
        self.upconv5 = UpConv(c4, nf)
        self.bn5 = _bn(nf)
        self.conv5 = _conv_elu(nf + c3, nf)
        self.upconv4 = UpConv(nf, nf // 2)
        self.bn4 = _bn(nf // 2)
        self.conv4 = _conv_elu(nf // 2 + c2, nf // 2)
        self.bn4_2 = _bn(nf // 2)
        cat4 = nf // 2 + c2
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False)
        self.daspp_6 = AtrousConv(cat4 + nf // 4, nf // 4, 6)
        self.daspp_12 = AtrousConv(cat4 + nf // 2, nf // 4, 12)
        self.daspp_18 = AtrousConv(cat4 + 3 * (nf // 4), nf // 4, 18)
        self.daspp_24 = AtrousConv(cat4 + nf, nf // 4, 24)
        self.daspp_conv = _conv_elu(nf // 2 + 5 * (nf // 4), nf // 4)
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth)
        self.upconv3 = UpConv(nf // 4, nf // 4)
        self.bn3 = _bn(nf // 4)
        self.conv3 = _conv_elu(nf // 4 + c1 + 1, nf // 4)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth)
        self.upconv2 = UpConv(nf // 4, nf // 8)
        self.bn2 = _bn(nf // 8)
        self.conv2 = _conv_elu(nf // 8 + c0 + 1, nf // 8)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth)
        self.upconv1 = UpConv(nf // 8, nf // 16)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth,
                                     is_final=True)
        r1_ch = 1 if nf // 32 >= 4 else 4     # see Reduction1x1.forward
        self.conv1 = _conv_elu(nf // 16 + r1_ch + 3, nf // 16)
        self.conv_depth = conv2d(nf // 16, 1, 3, padding=1)

    @torch.no_grad()
    def init_params(self, generator):
        # flax's default bias init for conv_depth
        nn.init.zeros_(self.conv_depth.bias)

    def _plane(self, reduc, x, upratio):
        eq = reduc(x)
        normal = eq[:, :3]
        normal = normal / (torch.linalg.vector_norm(normal, dim=1,
                                                    keepdim=True) + 1e-12)
        eq = torch.cat([normal, eq[:, 3:]], dim=1)
        return local_planar_guidance(eq, upratio)[:, None] / self.max_depth

    def forward(self, features, focal=None):
        skip0, skip1, skip2, skip3, feat = features
        dense = F.relu(feat)

        up5 = resize_nearest_nchw(self.bn5(self.upconv5(dense)),
                                  skip3.shape[2:])
        i5 = self.conv5(torch.cat([up5, skip3], dim=1))

        up4 = resize_nearest_nchw(self.bn4(self.upconv4(i5)),
                                  skip2.shape[2:])
        cat4 = torch.cat([up4, skip2], dim=1)
        i4 = self.bn4_2(self.conv4(cat4))

        d3 = self.daspp_3(i4)
        c2 = torch.cat([cat4, d3], dim=1)
        d6 = self.daspp_6(c2)
        c3 = torch.cat([c2, d6], dim=1)
        d12 = self.daspp_12(c3)
        c4 = torch.cat([c3, d12], dim=1)
        d18 = self.daspp_18(c4)
        c5 = torch.cat([c4, d18], dim=1)
        d24 = self.daspp_24(c5)
        daspp_feat = self.daspp_conv(
            torch.cat([i4, d3, d6, d12, d18, d24], dim=1))

        depth_8x8 = self._plane(self.reduc8x8, daspp_feat, 8)
        h8, w8 = depth_8x8.shape[2:]
        d8_ds = resize_nearest_nchw(depth_8x8, (h8 // 4, w8 // 4))
        up3 = resize_nearest_nchw(self.bn3(self.upconv3(daspp_feat)),
                                  skip1.shape[2:])
        d8_ds = resize_nearest_nchw(d8_ds, skip1.shape[2:])
        i3 = self.conv3(torch.cat([up3, skip1, d8_ds], dim=1))

        depth_4x4 = self._plane(self.reduc4x4, i3, 4)
        h4, w4 = depth_4x4.shape[2:]
        d4_ds = resize_nearest_nchw(depth_4x4, (h4 // 2, w4 // 2))
        up2 = resize_nearest_nchw(self.bn2(self.upconv2(i3)),
                                  skip0.shape[2:])
        d4_ds = resize_nearest_nchw(d4_ds, skip0.shape[2:])
        i2 = self.conv2(torch.cat([up2, skip0, d4_ds], dim=1))

        depth_2x2 = self._plane(self.reduc2x2, i2, 2)

        up1 = self.upconv1(i2)
        r1 = self.reduc1x1(up1)
        tgt = up1.shape[2:]
        i1 = self.conv1(torch.cat(
            [up1] + [resize_nearest_nchw(t, tgt) for t in
                     (r1, depth_2x2, depth_4x4, depth_8x8)], dim=1))

        out = self.conv_depth(i1)
        if self.scale_up:
            out = torch.sigmoid(out) * self.max_depth
        else:
            out = F.relu(out) + self.min_depth
        if self.final_norm and focal is not None:
            out = out * focal.reshape(-1, 1, 1, 1) / 715.0873
        return out
