"""Typed experiment configuration for the PyTorch port.

The same frozen dataclasses as `gedepth_tpu.configs.base`, cut to the fields
the serving slice reads. Field names and defaults are identical, so a preset
compares equal field by field with its JAX counterpart. `swin_scan` is not
among them: it changes only the JAX parameter layout, which
`convert.from_jax` unstacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # backbone (Swin-L defaults)
    embed_dims: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 7
    drop_path_rate: float = 0.3
    # neck
    neck_channels: Tuple[int, ...] = (64, 192, 384, 768, 1536)
    neck_embed_dim: int = 512
    neck_num_points: int = 8
    # the port serves 'windowed' only (models/hahi.py)
    neck_sampling: str = "bilinear"
    neck_window_radius: int = 4
    neck_hi_min_level: int = 0
    # the port serves 'none' only (models/depther.py)
    bf16_scope: str = "none"
    # head
    min_depth: float = 1e-3
    max_depth: float = 80.0
    # PE subsystem; the port serves 'adaptive' only
    pe_variant: str = "adaptive"
    depth_scale: float = 200.0
    default_cam_height: float = 1.65

    def build(self, device=None, generator=None):
        """The torch `GEDepth` for this configuration, in eval mode."""
        from gedepth_tpu_torch.models.depther import GEDepth
        return GEDepth(
            embed_dims=self.embed_dims, depths=self.depths,
            num_heads=self.num_heads, window=self.window,
            drop_path_rate=self.drop_path_rate,
            neck_channels=self.neck_channels,
            neck_embed_dim=self.neck_embed_dim,
            neck_num_points=self.neck_num_points,
            neck_sampling=self.neck_sampling,
            neck_window_radius=self.neck_window_radius,
            neck_hi_min_level=self.neck_hi_min_level,
            bf16_scope=self.bf16_scope,
            min_depth=self.min_depth, max_depth=self.max_depth,
            pe_variant=self.pe_variant, depth_scale=self.depth_scale,
            default_cam_height=self.default_cam_height,
            device=device, generator=generator).eval()


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "kitti"                # 'kitti' | 'synthetic'
    eval_size: Tuple[int, int] = (352, 1216)
    eval_flip_tta: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "gedepth_adaptive_kitti"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
