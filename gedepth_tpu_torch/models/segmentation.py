"""Segmentation models (the port of `gedepth_tpu.models.segmentation`):
mmseg-style FCN and OCR decode heads, the encoder-decoder and cascade
wrappers, and `SegOCRNet`, the ocrnet_hr18 analogue that trains on the PE
ground-mask task (`configs/_base_/models/ocrnet_hr18.py`).

Inside, NCHW; the models take and return NHWC, as the port's other
models do. Bilinear resizes are align_corners=False (the JAX
`resize_bilinear` default).

The OCR head is the JAX package's, not mmseg's OCRHead: a 3x3 conv-BN-ReLU
bottleneck, soft object regions from the prior head's logits (softmax over
classes, each class's weights over the pixels divided by their sum + 1e-6),
one head of scaled dot-product attention from the pixels (`query_proj`) to
the regions (`key_proj`, `value_proj`), then a 1x1 conv-BN-ReLU over
[features, context] and the 1x1 classifier.

Keys: a head's ConvModules are `convs.{i}` (and `conv_cat`) in the FCN head
and `bottleneck` and `fuse` in the OCR head, each with `conv` and `bn`;
the classifiers are `conv_seg`. `SegOCRNet` holds `backbone` (HRNet, mmcv
names), `aux_head` and `ocr_head`.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.hrnet import HRNet
from gedepth_tpu_torch.models.layers import (
    ConvModule, conv2d, init_weights, linear)
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw

Index = Union[int, Sequence[int]]


def resize_concat(inputs, indices):
    """mmseg's input_transform='resize_concat': the selected NCHW scales
    resized bilinearly to the first one's size and concatenated on
    channels."""
    sel = [inputs[i] for i in indices]
    size = sel[0].shape[2:]
    return torch.cat([sel[0]] + [resize_bilinear_nchw(f, size)
                                 for f in sel[1:]], dim=1)


def _select(inputs, in_index):
    if isinstance(in_index, (tuple, list)):
        return resize_concat(inputs, in_index)
    return inputs[in_index]


def _in_width(in_channels, in_index):
    if isinstance(in_index, (tuple, list)):
        return sum(in_channels[i] for i in in_index)
    return in_channels[in_index]


class FCNHead(nn.Module):
    """num_convs x (k x k conv-BN-ReLU) [-> conv_cat over (input, x)] -> 1x1
    classifier. in_channels: the widths of the pyramid; in_index: one
    scale, or a tuple of scales that are resized and concatenated."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 num_classes: int = 2, num_convs: int = 2,
                 in_index: Index = -1, concat_input: bool = False,
                 kernel_size: int = 3):
        super().__init__()
        self.in_index = in_index
        cin = _in_width(in_channels, in_index)
        self.convs = nn.ModuleList(
            ConvModule(cin if i == 0 else channels, channels, kernel_size,
                       use_norm=True, act=F.relu)
            for i in range(num_convs))
        self.conv_cat = (ConvModule(cin + channels, channels, 3,
                                    use_norm=True, act=F.relu)
                         if concat_input else None)
        self.conv_seg = conv2d(channels, num_classes, 1)

    def init_params(self, gen):
        nn.init.zeros_(self.conv_seg.bias)

    def forward(self, inputs):
        x = inp = _select(inputs, self.in_index)
        for conv in self.convs:
            x = conv(x)
        if self.conv_cat is not None:
            x = self.conv_cat(torch.cat([inp, x], dim=1))
        return self.conv_seg(x)


class OCRHead(nn.Module):
    """Object-contextual representations over the prior head's logits
    (`prev_logits`, NCHW at any size); see the module docstring."""

    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 ocr_channels: int = 128, num_classes: int = 2,
                 in_index: Index = -1):
        super().__init__()
        self.in_index = in_index
        self.ocr_channels = ocr_channels
        self.bottleneck = ConvModule(_in_width(in_channels, in_index),
                                     channels, 3, use_norm=True, act=F.relu)
        self.query_proj = linear(channels, ocr_channels, init="lecun")
        self.key_proj = linear(channels, ocr_channels, init="lecun")
        self.value_proj = linear(channels, ocr_channels, init="lecun")
        self.fuse = ConvModule(channels + ocr_channels, channels, 1,
                               use_norm=True, act=F.relu)
        self.conv_seg = conv2d(channels, num_classes, 1)

    def init_params(self, gen):
        nn.init.zeros_(self.conv_seg.bias)

    def forward(self, inputs, prev_logits):
        feats = self.bottleneck(_select(inputs, self.in_index))
        B, C, H, W = feats.shape
        probs = torch.softmax(resize_bilinear_nchw(prev_logits, (H, W)),
                              dim=1)
        flat_f = feats.flatten(2).transpose(1, 2)             # (B, HW, C)
        flat_p = probs.flatten(2).transpose(1, 2)             # (B, HW, K)
        flat_p = flat_p / (flat_p.sum(dim=1, keepdim=True) + 1e-6)
        regions = flat_p.transpose(1, 2) @ flat_f             # (B, K, C)
        q = self.query_proj(flat_f)
        k = self.key_proj(regions)
        v = self.value_proj(regions)
        attn = torch.softmax(q @ k.transpose(1, 2)
                             / self.ocr_channels ** 0.5, dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(B, self.ocr_channels, H, W)
        return self.conv_seg(self.fuse(torch.cat([feats, ctx], dim=1)))


def _nhwc_at(logits, size):
    """NCHW logits resized bilinearly to `size`, as NHWC."""
    return resize_bilinear_nchw(logits, size).permute(0, 2, 3, 1)


class EncoderDecoderSeg(nn.Module):
    """backbone -> decode head; forward(img NHWC) -> logits NHWC at the
    input's size."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone, self.head = backbone, head

    def forward(self, img):
        feats = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        return _nhwc_at(self.head(feats), img.shape[1:3])


class CascadeEncoderDecoderSeg(nn.Module):
    """The first head's logits feed each later (OCR-style) head in turn;
    forward(img NHWC) -> the logits of every stage, NHWC at the input's
    size, the last the final prediction."""

    def __init__(self, backbone: nn.Module, first_head: nn.Module,
                 cascade_heads: Sequence[nn.Module]):
        super().__init__()
        self.backbone, self.first_head = backbone, first_head
        self.cascade_heads = nn.ModuleList(cascade_heads)

    def forward(self, img):
        feats = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        logits = self.first_head(feats)
        outs = [_nhwc_at(logits, img.shape[1:3])]
        for head in self.cascade_heads:
            logits = head(feats, logits)
            outs.append(_nhwc_at(logits, img.shape[1:3]))
        return outs


class SegOCRNet(nn.Module):
    """HRNet -> resize_concat of its four streams -> the cascade
    [FCNHead (one 1x1 conv-BN-ReLU, sum of the stream widths), OCRHead
    (ocr_channels, ocr_key_channels)]. Two classes: the PE ground mask.

    The `GEDepth` forward contract: forward(img (B, H, W, C≥3) NHWC,
    cam_height) -> {"seg_logits": [aux, final] (B, H, W, K) at the input's
    size, "depth": None, "y": None, "slope_logits": None, "pe_mask": None};
    it reads the RGB channels only. `pe_variant` stays the config's
    ('vanilla' in the preset), so the loader hands it the PE channel that
    the labels come from. Built on the CPU from `generator` (seed 0 when
    None), then moved to `device`."""

    arch = "seg"
    depth_scale = 200.0

    def __init__(self, backbone_arch: str = "w18", num_classes: int = 2,
                 ocr_channels: int = 512, ocr_key_channels: int = 256,
                 pe_variant: str = "vanilla",
                 min_depth: float = 1e-3, max_depth: float = 80.0,
                 default_cam_height: float = 1.65, device=None,
                 generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.pe_variant = pe_variant
        self.min_depth, self.max_depth = min_depth, max_depth
        self.default_cam_height = default_cam_height
        self.backbone = HRNet(backbone_arch)
        widths = self.backbone.channels
        idx = tuple(range(len(widths)))
        self.aux_head = FCNHead(widths, channels=sum(widths),
                                num_classes=num_classes, num_convs=1,
                                kernel_size=1, in_index=idx)
        self.ocr_head = OCRHead(widths, channels=ocr_channels,
                                ocr_channels=ocr_key_channels,
                                num_classes=num_classes, in_index=idx)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def set_generator(self, generator):
        """Nothing draws random numbers in this model (the train steps'
        interface)."""

    def forward(self, img, cam_height=None):
        size = img.shape[1:3]
        feats = self.backbone(img[..., :3].permute(0, 3, 1, 2).contiguous())
        aux = self.aux_head(feats)
        outs = [_nhwc_at(aux, size),
                _nhwc_at(self.ocr_head(feats, aux), size)]
        return {"seg_logits": outs, "depth": None, "y": None,
                "slope_logits": None, "pe_mask": None}
