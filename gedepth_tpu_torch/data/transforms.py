"""The KITTI test-time pipeline: bottom-centred crop, then normalisation.

Same transforms as `gedepth_tpu.data.transforms` (KBCrop, Normalize,
Compose) over the same sample dicts: `img` is (H, W, 5) float32 with RGB in
0..255, the clipped PE prior and the raw PE.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class KBCrop:
    """Bottom-centred KITTI crop of `img` to (height, width)."""

    def __init__(self, height=352, width=1216):
        self.height = height
        self.width = width

    def __call__(self, sample, rng=None):
        h, w = sample["img"].shape[:2]
        top = int(h - self.height)
        left = int((w - self.width) / 2)
        sample["img"] = sample["img"][top:top + self.height,
                                      left:left + self.width]
        return sample


class Normalize:
    """ImageNet-normalise RGB; divide the positive values of the clipped-PE
    channel by depth_scale; pass the raw-PE channel through."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 depth_scale=200.0):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.depth_scale = float(depth_scale)

    def __call__(self, sample, rng=None):
        img = sample["img"]
        rgb = (img[..., :3] - self.mean) / self.std
        if img.shape[-1] == 5:
            pe = img[..., 3].copy()
            pe[pe > 0] = pe[pe > 0] / self.depth_scale
            sample["img"] = np.concatenate(
                [rgb, pe[..., None], img[..., 4:5]], axis=-1)
        else:
            sample["img"] = rgb
        return sample


def build_test_pipeline(data_cfg):
    """Deterministic test-time pipeline for a DataConfig (KITTI or
    synthetic; `gedepth_tpu.eval.evaluator.build_test_pipeline`)."""
    if data_cfg.dataset == "kitti":
        return Compose([KBCrop(*data_cfg.eval_size),
                        Normalize(depth_scale=200.0)])
    if data_cfg.dataset == "synthetic":
        return Compose([Normalize(depth_scale=200.0)])
    raise NotImplementedError(
        f"dataset {data_cfg.dataset!r} is not ported yet")
