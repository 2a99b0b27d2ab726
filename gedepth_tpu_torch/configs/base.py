"""Typed experiment configuration for the PyTorch port.

The same frozen dataclasses as `gedepth_tpu.configs.base`, cut to the fields
the serving, training and evaluation slices read. Field names and defaults
are identical, so a preset compares equal field by field with its JAX
counterpart. Left out on purpose: `swin_scan` (it changes only the JAX
parameter layout, which `convert.from_jax` unstacks), `neck_value_bf16`
(bf16 values in an f32 neck: the port's
bf16 goes by `bf16_scope`, whole-model casts and `bf16_compute`).
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # architecture family: 'gedepth' (DepthFormer + HAHI + PE), a zoo
    # arch ('adabins', 'bts', 'dpt', 'binsformer', 'densedepth') or 'seg'
    # (HRNet + the FCN/OCR cascade on the PE ground mask)
    arch: str = "gedepth"
    # zoo: the ResNet depth ('50'), the EfficientNet ('b0', 'tf_b5') or
    # the HRNet ('w18', the default of 'seg')
    backbone_variant: str = ""
    backbone_embed_dims: int = 0      # zoo: 0 = the arch's default
    backbone_depth: int = 0           # zoo: 0 = the arch's default
    n_bins: int = 256                 # zoo: adabins / binsformer bins
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
    # remat in training: each Swin block is recomputed in the backward from
    # its input (torch.utils.checkpoint; the DropPath draws replayed), and
    # the deformable sampling keeps only its inputs for the backward, which
    # the port's `msda` op does with either setting (models/hahi.py)
    swin_remat: bool = True
    neck_msda_remat: bool = True
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
        """The torch model of this configuration, in eval mode: `GEDepth`,
        `ZooDepther` for a zoo arch ('adabins', 'bts', 'dpt',
        'binsformer', 'densedepth'), or `SegOCRNet` for 'seg' (OCR widths
        8 and 4 times head_channels: 512 and 256 at the default 64). A zoo
        or seg model takes the RGB channels of its input and none of the
        GEDepth fields."""
        if self.arch != "gedepth" and self.bf16_scope != "none":
            raise ValueError(f"bf16_scope {self.bf16_scope!r} names "
                             "GEDepth's modules; a zoo model takes "
                             "'none' (or a whole-model cast)")
        if self.arch == "seg":
            from gedepth_tpu_torch.models.segmentation import SegOCRNet
            return SegOCRNet(
                backbone_arch=self.backbone_variant or "w18",
                ocr_channels=8 * self.head_channels,
                ocr_key_channels=4 * self.head_channels,
                pe_variant=self.pe_variant, min_depth=self.min_depth,
                max_depth=self.max_depth,
                default_cam_height=self.default_cam_height,
                device=device, generator=generator).eval()
        if self.arch != "gedepth":
            from gedepth_tpu_torch.models.zoo import ZooDepther
            return ZooDepther(
                arch=self.arch, backbone_variant=self.backbone_variant,
                min_depth=self.min_depth, max_depth=self.max_depth,
                head_channels=self.head_channels,
                backbone_embed_dims=self.backbone_embed_dims,
                backbone_depth=self.backbone_depth, n_bins=self.n_bins,
                default_cam_height=self.default_cam_height,
                device=device, generator=generator).eval()
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
            swin_remat=self.swin_remat,
            neck_msda_remat=self.neck_msda_remat,
            bf16_scope=self.bf16_scope,
            head_channels=self.head_channels,
            min_depth=self.min_depth, max_depth=self.max_depth,
            pe_variant=self.pe_variant, depth_scale=self.depth_scale,
            vanilla_pe_multiplier=self.vanilla_pe_multiplier,
            default_cam_height=self.default_cam_height,
            device=device, generator=generator).eval()


@dataclass(frozen=True)
class DataConfig:
    # 'kitti' | 'ddad' | 'nyu' | 'sunrgbd' | 'cityscapes' | 'nuscenes' |
    # 'custom' | 'synthetic'
    dataset: str = "kitti"
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
    # NYU: per-sample scene classes from the split's paths (the zoo's
    # BinsFormer reads them; data.nyu.NYUDataset)
    scene_classes: bool = False
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
    # BinsFormer's auxiliary supervision: SigLoss (and the chamfer when on)
    # of decoder layers aux_loss_indices, times aux_loss_weights, on top of
    # the final layer's loss
    aux_loss_indices: Tuple[int, ...] = ()
    aux_loss_weights: Tuple[float, ...] = ()
    # BinsFormer's scene-class cross entropy on the class query's logits
    # (the batch's `scene_class`; data.nyu.NYUDataset with scene_classes)
    class_ce_weight: float = 0.0
    # the zoo's bin-centre chamfer (AdaBins' and BinsFormer's bin_edges;
    # models.losses.bins_chamfer_loss): off in every preset
    chamfer_weight: float = 0.0


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
    # loader worker processes (the reference's workers_per_gpu); 0: one
    # prefetch thread. The batches are the same for any count.
    num_workers: int = 0
    # 'epoch': a permutation of the train set each epoch (the reference's
    # DistributedSampler); 'replacement': i.i.d. uniform draws each step.
    # No preset of either package uses 'replacement': the field mirrors the
    # JAX TrainConfig, and the loader tests hold both rules to the JAX ones
    sampling: str = "epoch"


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


# datasets whose samples carry RGB alone (no plane embedding)
RGB_DATASETS = ("nyu", "sunrgbd", "cityscapes", "nuscenes", "custom")


def image_channels(cfg) -> int:
    """Channels of the model input a preset's data gives: 5 (RGB, clipped
    and raw PE) for a model with a PE variant on KITTI, DDAD or synthetic
    frames, 3 without a PE variant or on an RGB-only dataset (NYU, SUN
    RGB-D, Cityscapes, nuScenes, a custom folder: the model reads the RGB
    channels alone)."""
    if cfg.model.pe_variant == "none" or cfg.data.dataset in RGB_DATASETS:
        return 3
    return 5


def _boolean(key, val):
    if isinstance(val, str) and val.lower() in ("true", "false"):
        return val.lower() == "true"
    if isinstance(val, bool):
        return val
    raise ValueError(f"{key} takes true or false, got {val!r}")


def apply_options(cfg, options):
    """`key=value` overrides of dotted dataclass fields, as
    tools/train.py's --options: `data.data_root=/data/kitti`,
    `optim.max_lr=2e-4`, `data.crop_size=(384,640)`. A value is read by
    `ast.literal_eval`, or kept as a string when it is not a literal; a
    boolean field also takes `true` and `false` in any case
    (`model.swin_remat=false`)."""
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
        if isinstance(getattr(obj, parts[-1]), bool):
            val = _boolean(key, val)
        obj = dataclasses.replace(obj, **{parts[-1]: val})
        for parent, name in reversed(path):
            obj = dataclasses.replace(parent, **{name: obj})
        cfg = obj
    return cfg
