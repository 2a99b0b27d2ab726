"""Typed experiment configuration for the PyTorch port.

The same frozen dataclasses as `gedepth_tpu.configs.base`, cut to the fields
the serving, training and evaluation slices read. Field names and defaults
are identical, so a preset compares equal field by field with its JAX
counterpart. Left out on purpose: `swin_scan` (it changes only the JAX
parameter layout, which `convert.from_jax` unstacks), the remat switches
(memory only), `neck_value_bf16` (bf16 values in an f32 neck: the port's
bf16 goes by `bf16_scope`, whole-model casts and `bf16_compute`), the zoo's
fields, and the fields of modules not ported yet (NYU's scene classes,
multi-process loading).
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    # 'bilinear' (exact mmcv sampling) | 'nearest' | 'windowed' |
    # 'windowed_compat' (the reference parameter tree, displacements clamped
    # to the window); see ops/msda.py and models/hahi.py
    neck_sampling: str = "bilinear"
    neck_window_radius: int = 4
    neck_hi_min_level: int = 0
    # mixed precision for serving: 'none' | 'backbone' | 'backbone_neck' |
    # 'backbone_head' | 'backbone_neck_head' run the named modules in bf16
    # and the rest (always the PE necks and the fusion) in f32; the caller
    # casts the matching weights (apis.inference.cast_params_bf16)
    bf16_scope: str = "none"
    # head
    head_channels: int = 64
    min_depth: float = 1e-3
    max_depth: float = 80.0
    # PE subsystem
    pe_variant: str = "adaptive"          # 'none' | 'vanilla' | 'adaptive'
    depth_scale: float = 200.0
    vanilla_pe_multiplier: float = 200.0  # the reference hardcodes 200
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
            head_channels=self.head_channels,
            min_depth=self.min_depth, max_depth=self.max_depth,
            pe_variant=self.pe_variant, depth_scale=self.depth_scale,
            vanilla_pe_multiplier=self.vanilla_pe_multiplier,
            default_cam_height=self.default_cam_height,
            device=device, generator=generator).eval()


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "kitti"                # 'kitti' | 'ddad' | 'synthetic'
    data_root: str = "data/kitti"
    train_split: str = "splits/kitti_eigen_train.txt"
    test_split: str = "splits/kitti_eigen_test.txt"
    gt_depth_scale: float = 256.0         # KITTI's 16-bit PNG divisor
    crop_size: Tuple[int, int] = (352, 704)
    eval_size: Tuple[int, int] = (352, 1216)
    ratio_range: Tuple[float, float] = (0.5, 2.0)
    rotate_degree: float = 2.5
    flip_prob: float = 0.5
    garg_crop: bool = True
    eigen_crop: bool = False
    eval_flip_tta: bool = True
    # 'whole' or 'slide' (sliding-window inference; window and step default
    # to crop_size and half of it, see eval/evaluator.py)
    eval_mode: str = "whole"
    # DDAD: the (height, width) of DDADResize, (384, 640)
    ddad_resize: Optional[Tuple[int, int]] = None
    # the train set repeated this many times (data.wrappers.RepeatDataset)
    repeat_times: int = 1
    # samples of the synthetic train set
    synthetic_size: int = 64


@dataclass(frozen=True)
class OptimConfig:
    max_lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    warmup_iters: int = 16 * 1600
    warmup_ratio: float = 1.0 / 1000
    min_lr_ratio: float = 1e-8
    grad_clip_norm: float = 35.0
    sig_loss_weight: float = 1.0
    slope_ce_weight: float = 0.08


@dataclass(frozen=True)
class TrainConfig:
    max_iters: int = 1600 * 48
    global_batch: int = 16                # 8 GPUs x 2 in the reference
    eval_interval: int = 800
    checkpoint_interval: int = 800
    max_keep_ckpts: int = 2
    log_interval: int = 10
    seed: int = 0
    # the metric whose best value writes best_{save_best}.npz; rule 'less'
    # for the six error metrics, 'greater' for a1-a3 (train.loop.best_rule)
    save_best: str = "abs_rel"
    # bf16 mixed-precision training: forward and backward in bf16
    # (parameters and inputs cast at the apply boundary), master parameters,
    # gradients, optimizer state, losses and BatchNorm statistics f32
    bf16_compute: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "gedepth_adaptive_kitti"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    # the command-line trainer writes to work_dir/name
    work_dir: str = "work_dirs"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def apply_options(cfg, options):
    """`key=value` overrides of dotted dataclass fields, as
    tools/train.py's --options: `data.data_root=/data/kitti`,
    `optim.max_lr=2e-4`, `data.crop_size=(384,640)`. A value is read by
    `ast.literal_eval`, or kept as a string when it is not a literal."""
    for opt in options or []:
        key, _, raw = opt.partition("=")
        parts = key.split(".")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        path, obj = [], cfg
        for p in parts[:-1]:
            path.append((obj, p))
            obj = getattr(obj, p)
        obj = dataclasses.replace(obj, **{parts[-1]: val})
        for parent, name in reversed(path):
            obj = dataclasses.replace(parent, **{name: obj})
        cfg = obj
    return cfg
