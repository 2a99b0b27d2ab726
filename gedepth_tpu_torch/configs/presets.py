"""Named presets of the port (values as in `gedepth_tpu.configs`)."""
from __future__ import annotations

import dataclasses

from gedepth_tpu_torch.configs.base import (
    DataConfig, ExperimentConfig, ModelConfig, OptimConfig, TrainConfig)

def _ddad_data():
    """DDAD (configs/depthformer/depthformer_{v,a}_ddad.py of the
    reference): 384x640 crop and evaluation, no garg or eigen crop, no flip
    and no flip-TTA."""
    return DataConfig(
        dataset="ddad", data_root="data/DDAD",
        train_split="splits/ddad_train_split.txt",
        test_split="splits/ddad_val_split.txt",
        crop_size=(384, 640), eval_size=(384, 640),
        garg_crop=False, eigen_crop=False, eval_flip_tta=False,
        flip_prob=0.0, ddad_resize=(384, 640))


def _ddad_model(variant, **kw):
    return ModelConfig(pe_variant=variant, max_depth=200.0,
                       depth_scale=250.0, default_cam_height=1.55, **kw)


def _ddad(name, model):
    # no warmup, 38,400 iterations at a global batch of 32
    return ExperimentConfig(
        name=name, model=model, data=_ddad_data(),
        optim=OptimConfig(warmup_iters=0),
        train=TrainConfig(max_iters=38400, global_batch=32))


_PRESETS = {
    # DepthFormer Swin-L baseline (no ground embedding), KITTI
    "depthformer_baseline_kitti": lambda: ExperimentConfig(
        name="depthformer_baseline_kitti",
        model=ModelConfig(pe_variant="none"), data=DataConfig()),
    # GEDepth-Vanilla: the ground prior times the ground mask
    "gedepth_vanilla_kitti": lambda: ExperimentConfig(
        name="gedepth_vanilla_kitti",
        model=ModelConfig(pe_variant="vanilla"), data=DataConfig()),
    # GEDepth-Adaptive with the exact mmcv deformable sampling: the preset
    # that loads converted reference checkpoints
    "gedepth_adaptive_kitti": lambda: ExperimentConfig(
        name="gedepth_adaptive_kitti",
        model=ModelConfig(pe_variant="adaptive"), data=DataConfig()),
    # the same parameter tree sampled inside a window of +-6 level pixels
    # around each query's grid centre (displacements clamped)
    "gedepth_adaptive_kitti_compat": lambda: ExperimentConfig(
        name="gedepth_adaptive_kitti_compat",
        model=ModelConfig(pe_variant="adaptive",
                          neck_sampling="windowed_compat",
                          neck_window_radius=6),
        data=DataConfig()),
    # the parity serving preset: the compat tree at R = 5 with Swin and the
    # decode head's convs in bf16 and HAHI, the PE necks, the slope bins
    # and the fusion in f32 (the JAX package records a combined abs-rel
    # delta of 5.9e-4 against exact f32 on converted weights)
    "gedepth_adaptive_kitti_parity": lambda: ExperimentConfig(
        name="gedepth_adaptive_kitti_parity",
        model=ModelConfig(pe_variant="adaptive",
                          neck_sampling="windowed_compat",
                          neck_window_radius=5,
                          bf16_scope="backbone_head"),
        data=DataConfig()),
    # GEDepth-Adaptive Swin-L with the windowed deformable-attention neck
    # and HI self-attention queries from transformer level 1 on
    "gedepth_adaptive_kitti_tpu": lambda: ExperimentConfig(
        name="gedepth_adaptive_kitti_tpu",
        model=ModelConfig(pe_variant="adaptive", neck_sampling="windowed",
                          neck_hi_min_level=1),
        data=DataConfig()),
    # GEDepth-Vanilla and GEDepth-Adaptive on DDAD
    "gedepth_vanilla_ddad": lambda: _ddad("gedepth_vanilla_ddad",
                                          _ddad_model("vanilla")),
    "gedepth_adaptive_ddad": lambda: _ddad("gedepth_adaptive_ddad",
                                           _ddad_model("adaptive")),
    # the windowed neck with HI queries from level 1, DDAD's constants
    "gedepth_adaptive_ddad_tpu": lambda: _ddad(
        "gedepth_adaptive_ddad_tpu",
        _ddad_model("adaptive", neck_sampling="windowed",
                    neck_hi_min_level=1)),
    # Swin-T-sized smoke config on synthetic data (tests)
    "smoke_synthetic": lambda: ExperimentConfig(
        name="smoke_synthetic",
        model=ModelConfig(
            embed_dims=48, depths=(1, 1, 2, 1), num_heads=(2, 4, 8, 16),
            neck_channels=(64, 48, 96, 192, 384), neck_embed_dim=128,
            neck_num_points=4, drop_path_rate=0.1, pe_variant="adaptive"),
        data=DataConfig(dataset="synthetic", crop_size=(96, 192),
                        eval_size=(96, 192), synthetic_size=16),
        optim=OptimConfig(warmup_iters=10),
        train=TrainConfig(max_iters=50, global_batch=2, eval_interval=25,
                          checkpoint_interval=25)),
}


def list_configs():
    return sorted(_PRESETS)


def get_config(name: str, **overrides) -> ExperimentConfig:
    if name not in _PRESETS:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(list_configs())}")
    cfg = _PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
