"""GEDepth composition: backbone -> HAHI -> PE necks -> PE fusion -> decode
head (the port of `gedepth_tpu.models.depther` for pe_variant='adaptive',
bf16_scope='none' and the windowed neck).

`forward` takes and returns the JAX package's NHWC layout:
  img          (B, H, W, 5): normalised RGB, clipped PE / depth_scale, raw PE
  depth        (B, H/2, W/2, 1) fused depth before the clamp
  y            (B, H, W, 1) ground mask at input resolution
  slope_logits (B, H, W, 11)
  pe_mask      (B, H, W, 1) adaptive ground prior
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from gedepth_tpu_torch.models.hahi import HAHINeck
from gedepth_tpu_torch.models.heads import DenseDepthHead
from gedepth_tpu_torch.models.layers import Stochastic, init_weights
from gedepth_tpu_torch.models.necks import DynamicPENeckSoft, LightPEMaskNeck
from gedepth_tpu_torch.models.swin import DepthFormerSwin
from gedepth_tpu_torch.ops import pe_fusion as pe_ops
from gedepth_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_nchw


class GEDepth(nn.Module):
    """GEDepth-Adaptive. The modules are built without storage, then
    allocated on the CPU and initialised from `generator` (seed 0 when
    None), so the same seed gives the same weights on every device; then
    moved to `device`.

    `.train()` turns on what the JAX package's `train=True` does: batch
    statistics in every BatchNorm (updating the running ones as flax does),
    DropPath at rates linspace(0, drop_path_rate, Σdepths) in Swin and
    dropout 0.1 after both deformable attentions' output projections. The
    random layers draw from the generator given to `set_generator`."""

    def __init__(self, embed_dims: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window: int = 7,
                 drop_path_rate: float = 0.3,
                 neck_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 neck_embed_dim: int = 512, neck_num_points: int = 8,
                 neck_sampling: str = "windowed", neck_window_radius: int = 4,
                 neck_hi_min_level: int = 0, bf16_scope: str = "none",
                 min_depth: float = 1e-3, max_depth: float = 80.0,
                 pe_variant: str = "adaptive", depth_scale: float = 200.0,
                 default_cam_height: float = 1.65, device=None,
                 generator=None):
        super().__init__()
        if pe_variant != "adaptive":
            raise NotImplementedError(
                f"pe_variant {pe_variant!r} is not ported yet")
        if bf16_scope != "none":
            raise NotImplementedError(
                f"bf16_scope {bf16_scope!r} is not ported yet")
        self.min_depth, self.max_depth = min_depth, max_depth
        self.depth_scale = depth_scale
        self.default_cam_height = default_cam_height
        with torch.device("meta"):
            self.backbone = DepthFormerSwin(embed_dims, depths, num_heads,
                                            window,
                                            drop_path_rate=drop_path_rate)
            self.neck = HAHINeck(neck_channels, neck_channels, neck_embed_dim,
                                 num_points=neck_num_points,
                                 sampling=neck_sampling,
                                 window_radius=neck_window_radius,
                                 hi_min_level=neck_hi_min_level)
            self.pe_mask_neck = LightPEMaskNeck(neck_channels)
            self.dynamic_pe_neck = DynamicPENeckSoft(neck_channels)
            self.decode_head = DenseDepthHead(neck_channels,
                                              min_depth=min_depth)
        self.to_empty(device="cpu")
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        if device is not None:
            self.to(device)

    def set_generator(self, generator):
        """Hand `generator` (a `torch.Generator` on the model's device, or
        None) to every DropPath and Dropout; in training they draw from it
        and raise without one."""
        for m in self.modules():
            if isinstance(m, Stochastic):
                m.generator = generator

    def forward(self, img, cam_height=None):
        B, H, W, _ = img.shape
        feats = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        feats = self.neck(feats)
        y_small, _ = self.pe_mask_neck(feats)
        y = resize_bilinear_nchw(y_small, (H, W), align_corners=False)
        slope_logits = resize_bilinear_nchw(
            self.dynamic_pe_neck(feats), (H, W),
            align_corners=False).permute(0, 2, 3, 1).contiguous()
        if cam_height is None:
            h = torch.full((B,), self.default_cam_height, dtype=img.dtype,
                           device=img.device)
        else:
            h = cam_height.reshape(B).to(img.dtype)
        pe_mask = pe_ops.pe_fusion(slope_logits, img[..., 4].contiguous(),
                                   y[:, 0].contiguous(), h, self.depth_scale)
        depth = self.decode_head(feats, pe_mask[:, None], y)
        return {"depth": depth.permute(0, 2, 3, 1),
                "y": y.permute(0, 2, 3, 1),
                "slope_logits": slope_logits,
                "pe_mask": pe_mask[..., None]}

    def predict_depth(self, img, cam_height=None):
        """Clamp to [min_depth, max_depth] and resize to the input size
        (align_corners=True). Returns (B, H, W, 1)."""
        depth = self(img, cam_height)["depth"].clamp(self.min_depth,
                                                     self.max_depth)
        return resize_bilinear(depth, img.shape[1:3], align_corners=True)
