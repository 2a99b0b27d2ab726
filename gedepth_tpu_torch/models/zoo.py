"""The toolbox model zoo (the port of `gedepth_tpu.models.zoo`): a backbone
and decode-head pair of the reference's `configs/_base_/models/*.py` with
the forward contract of `GEDepth`, so every zoo model trains, evaluates and
serves through the same steps and tools.

Ported pairings:
  adabins    — EfficientNet (b0-b3, or timm's tf_ checkpoints) +
               AdabinsHead                  (_base_/models/adabins.py)
  bts        — ResNet (+ the stem level) + BTSHead  (_base_/models/bts.py)
  dpt        — ViT + DPTHead                 (_base_/models/dpt.py)
  densedepth — ResNet (+ the stem level) + DenseDepthHead
               (_base_/models/densedepth.py)
  binsformer — Swin (+ the conv stem) + BinsFormerHead
               (_base_/models/binsformer.py)
The segmentation arch 'seg' is `models.segmentation.SegOCRNet`. AdaBins
and BinsFormer also return their `bin_edges` (B, n_bins + 1), which the
bin-chamfer loss reads; BinsFormer its scene `class_logits` (B, 25) and, in
training, the outputs of its other decoder layers (`aux_layer_outs`), which
its auxiliary losses read.

BinsFormer's Swin is the JAX zoo's: DropPath at rates up to 0.3 and remat in
training (`models.swin`), whatever the config's `drop_path_rate` and
`swin_remat` say, as in the JAX package; its DropPath draws from the
generator of `set_generator`.

A zoo model reads the RGB channels of its input only: a KITTI preset keeps
the config's `pe_variant`, so the loader and the serving API hand it the
5-channel input, and the model's own `pe_variant` is 'none' (its train
step takes no slope loss), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from gedepth_tpu_torch.models.adabins import AdabinsHead
from gedepth_tpu_torch.models.binsformer import BinsFormerHead
from gedepth_tpu_torch.models.bts import BTSHead
from gedepth_tpu_torch.models.dpt import DPTHead
from gedepth_tpu_torch.models.efficientnet import (
    EfficientNet, TimmEfficientNet)
from gedepth_tpu_torch.models.heads import DenseDepthHead
from gedepth_tpu_torch.models.layers import Stochastic, init_weights
from gedepth_tpu_torch.models.resnet import ResNet
from gedepth_tpu_torch.models.swin import DepthFormerSwin
from gedepth_tpu_torch.models.vit import VisionTransformer, out_indices_for
from gedepth_tpu_torch.ops.resize import resize_bilinear

ZOO_ARCHS = ("adabins", "bts", "dpt", "binsformer", "densedepth")
PORTED_ARCHS = ("adabins", "bts", "dpt", "binsformer", "densedepth")
# where each arch that is not ported yet stands in ROADMAP.md Queue 1
ZOO_ROADMAP = {}
# BinsFormer's head caps the bins at 64 (the JAX zoo's rule)
BINSFORMER_MAX_BINS = 64


def not_ported(arch):
    return NotImplementedError(
        f"arch {arch!r} is not ported yet (ROADMAP.md Queue 1, "
        f"'{ZOO_ROADMAP[arch]}')" if arch in ZOO_ROADMAP
        else f"unknown arch {arch!r}")


class ZooDepther(nn.Module):
    """Backbone and decode head with the `GEDepth` contract: forward(img
    (B, H, W, C≥3) NHWC, cam_height) -> {"depth" (B, H', W', 1), "y": None,
    "slope_logits": None, "pe_mask": None}, and for AdaBins and
    BinsFormer "bin_edges" (B, n_bins + 1), for BinsFormer "class_logits"
    (B, 25) and, in training, "aux_layer_outs": the dicts of its decoder
    layers but the last ("depth" NHWC, "bin_edges", "class_logits"). Built
    on the CPU from `generator` (seed 0 when None), then moved to
    `device`."""

    # interface of GEDepth that the steps read
    pe_variant = "none"
    depth_scale = 200.0        # the JAX eval step's default for the zoo

    def __init__(self, arch: str = "bts", backbone_variant: str = "",
                 min_depth: float = 1e-3, max_depth: float = 10.0,
                 head_channels: int = 128, backbone_embed_dims: int = 0,
                 backbone_depth: int = 0, n_bins: int = 256,
                 default_cam_height: float = 1.65, device=None,
                 generator=None):
        super().__init__()
        if arch not in PORTED_ARCHS:
            raise not_ported(arch)
        self.arch = arch
        self.min_depth, self.max_depth = min_depth, max_depth
        self.default_cam_height = default_cam_height
        if arch == "dpt":
            # ViT-Base by default: 768 wide, 12 blocks, heads of 64
            ed = backbone_embed_dims or 768
            self.backbone = VisionTransformer(
                embed_dims=ed, depth=backbone_depth or 12,
                num_heads=max(1, ed // 64),
                out_indices=out_indices_for(backbone_depth or 12))
            post = tuple(max(8, ed * m // 8) for m in (1, 2, 4, 8))
            self.decode_head = DPTHead(ed, post, channels=head_channels,
                                       min_depth=min_depth)
        elif arch == "binsformer":
            # Swin-T by default: 96 wide, heads of 32
            ed = backbone_embed_dims or 96
            self.backbone = DepthFormerSwin(
                embed_dims=ed, depths=(2, 2, 6, 2),
                num_heads=tuple(max(1, ed * m // 96) for m in (3, 6, 12, 24)),
                use_pe=False)
            chans = (self.backbone.conv1.out_channels,) + tuple(
                ed * 2 ** i for i in range(4))
            self.decode_head = BinsFormerHead(
                chans, conv_dim=head_channels,
                n_bins=min(n_bins, BINSFORMER_MAX_BINS),
                min_depth=min_depth, max_depth=max_depth)
        elif arch == "adabins":
            variant = backbone_variant or "b0"
            self.backbone = (TimmEfficientNet(variant)
                             if variant.startswith("tf_")
                             else EfficientNet(variant))
            widths = tuple(head_channels * 2 ** i
                           for i in range(len(self.backbone.channels)))
            self.decode_head = AdabinsHead(
                self.backbone.channels, widths, channels=head_channels,
                n_bins=n_bins, min_depth=min_depth, max_depth=max_depth)
        else:
            self.backbone = ResNet(depth=int(backbone_variant or 50),
                                   include_stem=True)
            if arch == "bts":
                self.decode_head = BTSHead(self.backbone.channels,
                                           num_features=head_channels * 4,
                                           min_depth=min_depth,
                                           max_depth=max_depth)
            else:
                self.decode_head = DenseDepthHead(self.backbone.channels,
                                                  channels=head_channels,
                                                  min_depth=min_depth)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def set_generator(self, generator):
        """Hand `generator` to every DropPath and Dropout (BinsFormer's
        Swin; the other zoo models have none), as `GEDepth.set_generator`
        does."""
        for m in self.modules():
            if isinstance(m, Stochastic):
                m.generator = generator

    def forward(self, img, cam_height=None):
        rgb = img[..., :3].permute(0, 3, 1, 2).contiguous()
        depth = self.decode_head(self.backbone(rgb))
        out = {"y": None, "slope_logits": None, "pe_mask": None}
        if self.arch == "binsformer":
            layers = [dict(o, depth=o["depth"].permute(0, 2, 3, 1))
                      for o in depth]
            out.update(layers[-1])
            if self.training:
                out["aux_layer_outs"] = layers[:-1]
            return out
        if self.arch == "adabins":
            depth, out["bin_edges"] = depth
        out["depth"] = depth.permute(0, 2, 3, 1)
        return out

    def predict_depth(self, img, cam_height=None):
        """Clamp to [min_depth, max_depth] and resize to the input size
        (align_corners=True). Returns (B, H, W, 1)."""
        depth = self(img, cam_height)["depth"].clamp(self.min_depth,
                                                     self.max_depth)
        return resize_bilinear(depth, img.shape[1:3], align_corners=True)
