"""Stage-1 ground-mask pretraining (the port of
`gedepth_tpu.models.pretrain`).

The reference trains a ground-mask segmentation model first and overlays
its backbone onto the depth model before GEDepth training. The mask's
ground truth is "the plane prior agrees with the lidar depth within 3%".
`GroundMaskPretrain` is the depth model's Swin-L and HAHI neck with the
five outputs fused at the stem's resolution (`necks.ScaleFuse`, 64
channels) and a 3x3 conv to two classes, upsampled to the input with
align_corners=True; its backbone's keys are those of `GEDepth`, so the
overlay needs no renaming. The neck samples with the exact rule
('bilinear'), the JAX model's default, whatever a preset's neck_sampling.

The backbone file (`save_backbone`, `load_backbone`) is the JAX package's
params-only `.npz` holding `params/backbone/...` only, so each package
reads the other's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from gedepth_tpu_torch.convert.from_jax import (
    flax_variables_from_state_dict, state_dict_from_flax)
from gedepth_tpu_torch.models.hahi import HAHINeck
from gedepth_tpu_torch.models.layers import Stochastic, conv2d, init_weights
from gedepth_tpu_torch.models.losses import weighted_ce_ignore  # noqa: F401
from gedepth_tpu_torch.models.necks import ScaleFuse
from gedepth_tpu_torch.models.swin import DepthFormerSwin
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw
from gedepth_tpu_torch.train.checkpoint import read_flax_npz, write_flax_npz

MASK_REL_TOL = 0.03       # the training labels' agreement of prior and lidar


def ground_mask_gt(pe: np.ndarray, gt: np.ndarray,
                   rel_tol: float = MASK_REL_TOL) -> np.ndarray:
    """Binary ground mask, float32: the prior within rel_tol of the lidar
    depth; 0 where gt is 0."""
    err = np.divide(np.abs(pe - gt), gt, out=np.zeros_like(gt),
                    where=gt != 0)
    return np.logical_and(err <= rel_tol, gt > 0).astype(np.float32)


def mask_labels(img, depth_gt, rel_tol: float = MASK_REL_TOL):
    """The training labels of a batch (`tools/pretrain_pe_mask.py` of the
    JAX package): 1 where the raw prior (channel 4) lies within rel_tol of
    the lidar depth, else 0."""
    pe = img[..., 4]
    err = (pe - depth_gt).abs() / depth_gt.clamp_min(1e-6)
    return ((depth_gt > 0) & (err <= rel_tol)).to(img.dtype)


class GroundMaskPretrain(nn.Module):
    """Swin-L -> HAHI (exact sampling) -> fuse -> classifier; forward(img
    (B, H, W, 5)) -> (B, H, W, num_classes) logits. Built and initialised as
    `GEDepth` is: on the meta device, allocated on the CPU, seeded from
    `generator`, then moved to `device`; in eval mode. Its Swin blocks
    recompute in the backward (remat), as the JAX model's backbone does by
    default."""

    def __init__(self, embed_dims: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window: int = 7,
                 drop_path_rate: float = 0.3,
                 neck_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 neck_embed_dim: int = 512, neck_num_points: int = 8,
                 use_pe_input: bool = True, num_classes: int = 2,
                 device=None, generator=None):
        super().__init__()
        with torch.device("meta"):
            self.backbone = DepthFormerSwin(embed_dims, depths, num_heads,
                                            window,
                                            drop_path_rate=drop_path_rate,
                                            use_pe=use_pe_input)
            self.neck = HAHINeck(neck_channels, neck_channels, neck_embed_dim,
                                 num_points=neck_num_points,
                                 sampling="bilinear")
            self.fuse = ScaleFuse(neck_channels, 64)
            self.classifier = conv2d(64, num_classes, 3, padding=1,
                                     init="xavier")
        self.to_empty(device="cpu")
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)
        self.eval()

    @classmethod
    def from_config(cls, mcfg, device=None, generator=None):
        """The model for a `ModelConfig`'s backbone and neck widths."""
        return cls(embed_dims=mcfg.embed_dims, depths=mcfg.depths,
                   num_heads=mcfg.num_heads, window=mcfg.window,
                   drop_path_rate=mcfg.drop_path_rate,
                   neck_channels=mcfg.neck_channels,
                   neck_embed_dim=mcfg.neck_embed_dim,
                   neck_num_points=mcfg.neck_num_points, device=device,
                   generator=generator)

    def set_generator(self, generator):
        for m in self.modules():
            if isinstance(m, Stochastic):
                m.generator = generator

    def forward(self, img, cam_height=None):
        H, W = img.shape[1:3]
        feats = self.neck(self.backbone(img.permute(0, 3, 1, 2).contiguous()))
        logits = self.classifier(self.fuse(feats))
        return resize_bilinear_nchw(logits, (H, W), align_corners=True
                                    ).permute(0, 2, 3, 1)


def extract_backbone(model) -> dict:
    """The backbone's parameters of `model` (`backbone.*`, no buffers: the
    JAX overlay carries params, not batch statistics)."""
    return {name: p.detach() for name, p in model.named_parameters()
            if name.startswith("backbone.")}


@torch.no_grad()
def overlay_backbone(model, backbone: dict):
    """Replace `model`'s backbone parameters by `backbone` (name -> tensor,
    as `extract_backbone` or `load_backbone` give), in place; the names and
    shapes must match exactly. Returns the model."""
    own = extract_backbone(model)
    missing = sorted(set(own) - set(backbone))
    extra = sorted(set(backbone) - set(own))
    shapes = [k for k in own if k in backbone
              and tuple(backbone[k].shape) != tuple(own[k].shape)]
    if missing or extra or shapes:
        raise ValueError(f"backbone does not fit: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}, other shapes {shapes[:4]}")
    for name, p in own.items():
        p.copy_(backbone[name])
    return model


def save_backbone(path: str, model):
    """Write `model`'s backbone parameters as a params-only `.npz` in the
    JAX key layout (`params/backbone/...`)."""
    params, _ = flax_variables_from_state_dict(extract_backbone(model))
    write_flax_npz(path, params)


def load_backbone(path: str) -> dict:
    """The `backbone.*` tensors (f32, CPU) of a backbone `.npz` of either
    package (per-block or scanned Swin layout)."""
    params, _ = read_flax_npz(path)
    if "backbone" not in params:
        raise ValueError(f"{path} holds no params/backbone")
    return state_dict_from_flax({"backbone": params["backbone"]})
