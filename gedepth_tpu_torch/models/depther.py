"""GEDepth composition: backbone -> HAHI -> PE necks -> PE fusion -> decode
head (the port of `gedepth_tpu.models.depther`).

Mixed precision for serving, `bf16_scope`: the named modules run in bf16 and
the rest in f32. The model casts activations at the scope's boundaries; the
caller casts the matching parameters (`apis.inference.cast_params_bf16`).
The PE necks, the slope bins, the prior (up to depth_scale = 200, 8 mantissa
bits in bf16) and the fusion d·(1 − y) + pe stay f32 in every scope:
  * 'backbone'            Swin only
  * 'backbone_neck'       Swin + HAHI
  * 'backbone_head'       Swin + decode head (HAHI f32)
  * 'backbone_neck_head'  all but the PE necks and the fusion
A model whose every parameter was cast (scope 'all' of `cast_params_bf16`)
follows a bf16 input through in bf16, fusion included; `bf16_scope` stays
'none' for that.

PE variants:
  * 'none'     the DepthFormer baseline: RGB only, depth = relu(conv) +
    min_depth, no PE necks;
  * 'vanilla'  pe_mask = img[..., 3]·y·vanilla_pe_multiplier (200, as the
    reference hardcodes it, even where depth_scale is 250);
  * 'adaptive' slope-bin logits -> expected slope -> the ground prior
    re-derived per pixel with the sample's camera height (`ops.pe_fusion`).

`forward` takes and returns the JAX package's NHWC layout:
  img          (B, H, W, 5): normalised RGB, clipped PE / depth_scale, raw
               PE; (B, H, W, 3) suffices for 'none'
  depth        (B, H/2, W/2, 1) fused depth before the clamp
  y            (B, H, W, 1) ground mask at input resolution (None for 'none')
  slope_logits (B, H, W, 11) ('adaptive' only, else None)
  pe_mask      (B, H, W, 1) the ground prior (None for 'none')
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


PE_VARIANTS = ("none", "vanilla", "adaptive")
BF16_SCOPES = ("none", "backbone", "backbone_neck", "backbone_head",
               "backbone_neck_head")


class GEDepth(nn.Module):
    """GEDepth. The modules are built without storage, then allocated on
    the CPU and initialised from `generator` (seed 0 when None), so the same
    seed gives the same weights on every device; then moved to `device`.

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
                 neck_sampling: str = "bilinear", neck_window_radius: int = 4,
                 neck_hi_min_level: int = 0, bf16_scope: str = "none",
                 head_channels: int = 64,
                 min_depth: float = 1e-3, max_depth: float = 80.0,
                 pe_variant: str = "adaptive", depth_scale: float = 200.0,
                 vanilla_pe_multiplier: float = 200.0,
                 default_cam_height: float = 1.65, device=None,
                 generator=None):
        super().__init__()
        if pe_variant not in PE_VARIANTS:
            raise ValueError(f"pe_variant {pe_variant!r} not in {PE_VARIANTS}")
        if bf16_scope not in BF16_SCOPES:
            raise ValueError(f"bf16_scope {bf16_scope!r} not in {BF16_SCOPES}")
        self.bf16_scope = bf16_scope
        self.min_depth, self.max_depth = min_depth, max_depth
        self.pe_variant, self.depth_scale = pe_variant, depth_scale
        self.vanilla_pe_multiplier = vanilla_pe_multiplier
        self.default_cam_height = default_cam_height
        with torch.device("meta"):
            self.backbone = DepthFormerSwin(embed_dims, depths, num_heads,
                                            window,
                                            drop_path_rate=drop_path_rate,
                                            use_pe=pe_variant != "none")
            self.neck = HAHINeck(neck_channels, neck_channels, neck_embed_dim,
                                 num_points=neck_num_points,
                                 sampling=neck_sampling,
                                 window_radius=neck_window_radius,
                                 hi_min_level=neck_hi_min_level)
            if pe_variant != "none":
                self.pe_mask_neck = LightPEMaskNeck(neck_channels)
            if pe_variant == "adaptive":
                self.dynamic_pe_neck = DynamicPENeckSoft(neck_channels)
            self.decode_head = DenseDepthHead(neck_channels,
                                              channels=head_channels,
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
        scope = self.bf16_scope
        x = img.to(torch.bfloat16) if scope != "none" else img
        feats = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        if scope in ("backbone", "backbone_head"):
            feats = [f.float() for f in feats]
        feats = self.neck(feats)
        if scope in ("backbone_neck", "backbone_neck_head"):
            feats = [f.float() for f in feats]
        head_in = feats
        if scope in ("backbone_head", "backbone_neck_head"):
            # the head's convs run in bf16; pe_mask and y stay f32, so the
            # fusion d·(1 − y) + pe inside the head promotes back to f32
            head_in = [f.to(torch.bfloat16) for f in feats]
        if self.pe_variant == "none":
            depth = self.decode_head(head_in)
            return {"depth": depth.permute(0, 2, 3, 1), "y": None,
                    "slope_logits": None, "pe_mask": None}
        y_small, _ = self.pe_mask_neck(feats)
        y = resize_bilinear_nchw(y_small, (H, W), align_corners=False)
        slope_logits = None
        if self.pe_variant == "adaptive":
            slope_logits = resize_bilinear_nchw(
                self.dynamic_pe_neck(feats), (H, W),
                align_corners=False).permute(0, 2, 3, 1).contiguous()
            if cam_height is None:
                h = torch.full((B,), self.default_cam_height,
                               dtype=img.dtype, device=img.device)
            else:
                h = cam_height.reshape(B).to(img.dtype)
            pe_mask = pe_ops.pe_fusion(slope_logits,
                                       img[..., 4].contiguous(),
                                       y[:, 0].contiguous(), h,
                                       self.depth_scale)
        else:
            pe_mask = img[..., 3] * y[:, 0] * self.vanilla_pe_multiplier
        depth = self.decode_head(head_in, pe_mask[:, None], y)
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
