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


def _nyu_data():
    """NYU Depth v2 (configs/_base_/datasets/nyu.py of the reference): GT
    PNG / 1000, a 416x544 crop, the eigen crop in evaluation, flip and
    flip-TTA."""
    return DataConfig(
        dataset="nyu", data_root="data/nyu",
        train_split="splits/nyu_train.txt", test_split="splits/nyu_test.txt",
        gt_depth_scale=1000.0, crop_size=(416, 544), eval_size=(416, 544),
        garg_crop=False, eigen_crop=True, flip_prob=0.5,
        eval_flip_tta=True)


def _ddad_model(variant, **kw):
    return ModelConfig(pe_variant=variant, max_depth=200.0,
                       depth_scale=250.0, default_cam_height=1.55, **kw)


def _ddad(name, model):
    # no warmup, 38,400 iterations at a global batch of 32
    return ExperimentConfig(
        name=name, model=model, data=_ddad_data(),
        optim=OptimConfig(warmup_iters=0),
        train=TrainConfig(max_iters=38400, global_batch=32, num_workers=4))


def _kitti(name, model):
    # four loader workers for the KITTI chain, as the JAX presets have it
    return ExperimentConfig(name=name, model=model, data=DataConfig(),
                            train=TrainConfig(num_workers=4))


_PRESETS = {
    # DepthFormer Swin-L baseline (no ground embedding), KITTI
    "depthformer_baseline_kitti": lambda: _kitti(
        "depthformer_baseline_kitti", ModelConfig(pe_variant="none")),
    # GEDepth-Vanilla: the ground prior times the ground mask
    "gedepth_vanilla_kitti": lambda: _kitti(
        "gedepth_vanilla_kitti", ModelConfig(pe_variant="vanilla")),
    # GEDepth-Adaptive with the exact mmcv deformable sampling: the preset
    # that loads converted reference checkpoints
    "gedepth_adaptive_kitti": lambda: _kitti(
        "gedepth_adaptive_kitti", ModelConfig(pe_variant="adaptive")),
    # the same parameter tree sampled inside a window of +-6 level pixels
    # around each query's grid centre (displacements clamped)
    "gedepth_adaptive_kitti_compat": lambda: _kitti(
        "gedepth_adaptive_kitti_compat",
        ModelConfig(pe_variant="adaptive", neck_sampling="windowed_compat",
                    neck_window_radius=6)),
    # the parity serving preset: the compat tree at R = 5 with Swin and the
    # decode head's convs in bf16 and HAHI, the PE necks, the slope bins
    # and the fusion in f32 (the JAX package records a combined abs-rel
    # delta of 5.9e-4 against exact f32 on converted weights)
    "gedepth_adaptive_kitti_parity": lambda: _kitti(
        "gedepth_adaptive_kitti_parity",
        ModelConfig(pe_variant="adaptive", neck_sampling="windowed_compat",
                    neck_window_radius=5, bf16_scope="backbone_head")),
    # GEDepth-Adaptive Swin-L with the windowed deformable-attention neck
    # and HI self-attention queries from transformer level 1 on
    "gedepth_adaptive_kitti_tpu": lambda: _kitti(
        "gedepth_adaptive_kitti_tpu",
        ModelConfig(pe_variant="adaptive", neck_sampling="windowed",
                    neck_hi_min_level=1)),
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
    # the toolbox model zoo (the reference's configs/_base_/models/*.py).
    # All keep the default pe_variant 'adaptive', as the JAX presets do:
    # the KITTI loader reads the PE channels and the model ignores them;
    # NYU frames carry RGB alone.
    # AdaBins: EfficientNet + the mini-ViT's adaptive bins
    # (_base_/models/adabins.py; SigLoss weight 10)
    "adabins_nyu": lambda: ExperimentConfig(
        name="adabins_nyu",
        model=ModelConfig(arch="adabins", backbone_variant="b0",
                          head_channels=128, n_bins=256, max_depth=10.0),
        data=_nyu_data(),
        optim=OptimConfig(sig_loss_weight=10.0),
        train=TrainConfig(max_iters=38400, global_batch=16)),
    # BinsFormer: Swin-T + the bins transformer head
    # (_base_/models/binsformer.py, configs/binsformer/*_nyu.py): 64 bins
    # and the scene-class query, SigLoss 10, the auxiliary losses of
    # decoder layers 2 and 5, the class CE 1e-2
    "binsformer_nyu": lambda: ExperimentConfig(
        name="binsformer_nyu",
        model=ModelConfig(arch="binsformer", n_bins=64, max_depth=10.0),
        data=dataclasses.replace(_nyu_data(), scene_classes=True),
        optim=OptimConfig(sig_loss_weight=10.0, aux_loss_indices=(2, 5),
                          aux_loss_weights=(0.25, 0.5),
                          class_ce_weight=1e-2),
        train=TrainConfig(max_iters=38400, global_batch=16)),
    # BTS: ResNet-50 + local planar guidance (_base_/models/bts.py)
    "bts_kitti": lambda: ExperimentConfig(
        name="bts_kitti",
        model=ModelConfig(arch="bts", backbone_variant="50",
                          head_channels=128, max_depth=80.0),
        data=DataConfig()),
    # DPT: ViT-Base + the reassemble and fusion head (_base_/models/dpt.py
    # sets no loss: the base head's SigLoss weight 10)
    "dpt_kitti": lambda: ExperimentConfig(
        name="dpt_kitti",
        model=ModelConfig(arch="dpt", head_channels=256, max_depth=80.0),
        data=DataConfig(),
        optim=OptimConfig(sig_loss_weight=10.0)),
    # DenseDepth: ResNet-50 + the upsample chain (_base_/models/densedepth.py)
    "densedepth_kitti": lambda: ExperimentConfig(
        name="densedepth_kitti",
        model=ModelConfig(arch="densedepth", backbone_variant="50",
                          head_channels=128, max_depth=80.0),
        data=DataConfig()),
    # OCRNet-HR18 (_base_/models/ocrnet_hr18.py): HRNet-W18 + the FCN/OCR
    # cascade on the PE ground-mask segmentation task, scored by mIoU
    # (`eval.SegEvaluator`); pe_variant 'vanilla' makes the data layer
    # load the PE channel the labels come from
    "ocrnet_hr18_kitti": lambda: ExperimentConfig(
        name="ocrnet_hr18_kitti",
        model=ModelConfig(arch="seg", backbone_variant="w18",
                          head_channels=64, pe_variant="vanilla"),
        data=DataConfig()),
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
