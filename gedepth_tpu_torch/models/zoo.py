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
'binsformer' (and the segmentation model 'seg') are not ported yet
(ROADMAP Queue 1). AdaBins also returns its `bin_edges` (B, n_bins + 1),
which the bin-chamfer loss reads.

A zoo model reads the RGB channels of its input only: a KITTI preset keeps
the config's `pe_variant`, so the loader and the serving API hand it the
5-channel input, and the model's own `pe_variant` is 'none' (its train
step takes no slope loss), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from gedepth_tpu_torch.models.adabins import AdabinsHead
from gedepth_tpu_torch.models.bts import BTSHead
from gedepth_tpu_torch.models.dpt import DPTHead
from gedepth_tpu_torch.models.efficientnet import (
    EfficientNet, TimmEfficientNet)
from gedepth_tpu_torch.models.heads import DenseDepthHead
from gedepth_tpu_torch.models.layers import init_weights
from gedepth_tpu_torch.models.resnet import ResNet
from gedepth_tpu_torch.models.vit import VisionTransformer, out_indices_for
from gedepth_tpu_torch.ops.resize import resize_bilinear

ZOO_ARCHS = ("adabins", "bts", "dpt", "binsformer", "densedepth")
PORTED_ARCHS = ("adabins", "bts", "dpt", "densedepth")
# where each arch that is not ported yet stands in ROADMAP.md Queue 1
ZOO_ROADMAP = {"binsformer": "Zoo 4: BinsFormer",
               "seg": "Zoo 5: HRNet and segmentation"}


def not_ported(arch):
    return NotImplementedError(
        f"arch {arch!r} is not ported yet (ROADMAP.md Queue 1, "
        f"'{ZOO_ROADMAP[arch]}')" if arch in ZOO_ROADMAP
        else f"unknown arch {arch!r}")


class ZooDepther(nn.Module):
    """Backbone and decode head with the `GEDepth` contract: forward(img
    (B, H, W, C≥3) NHWC, cam_height) -> {"depth" (B, H', W', 1), "y": None,
    "slope_logits": None, "pe_mask": None}, and for AdaBins "bin_edges"
    (B, n_bins + 1). Built on the CPU from
    `generator` (seed 0 when None), then moved to `device`."""

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
        """Nothing draws random numbers in a zoo model (no DropPath, no
        dropout); kept for the train step's contract."""

    def forward(self, img, cam_height=None):
        rgb = img[..., :3].permute(0, 3, 1, 2).contiguous()
        depth = self.decode_head(self.backbone(rgb))
        out = {"y": None, "slope_logits": None, "pe_mask": None}
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
