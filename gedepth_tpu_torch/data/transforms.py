"""Host-side pipelines over sample dicts: the KITTI test-time pipeline
(bottom-centred crop, normalisation) and the training augmentations of the
synthetic branch of `gedepth_tpu.train.loop.build_train_pipeline` (flip,
crop, colour). Same transforms as `gedepth_tpu.data.transforms`: `img` is
(H, W, 5) float32 with RGB in 0..255, the clipped PE prior and the raw PE;
`depth_gt` and `pe_k_gt` (H, W) follow every geometric step. A random
transform draws from the explicit `np.random.Generator` it is called with,
so a sample is a pure function of its seed.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)

_DEPTH_FIELDS = ("depth_gt", "pe_k_gt")


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


class RandomFlip:
    """Horizontal flip of img and the GT fields with probability `prob`."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            for key in ("img",) + _DEPTH_FIELDS:
                if key in sample:
                    sample[key] = np.ascontiguousarray(sample[key][:, ::-1])
            sample["flipped"] = True
        return sample


class RandomCrop:
    """Random crop of img and the GT fields to crop_size = (h, w)."""

    def __init__(self, crop_size=(352, 704)):
        self.crop_size = crop_size

    def __call__(self, sample, rng):
        ch, cw = self.crop_size
        h, w = sample["img"].shape[:2]
        off_h = int(rng.integers(0, max(h - ch, 0) + 1))
        off_w = int(rng.integers(0, max(w - cw, 0) + 1))
        sl = np.s_[off_h:off_h + ch, off_w:off_w + cw]
        for key in ("img",) + _DEPTH_FIELDS:
            if key in sample:
                sample[key] = sample[key][sl]
        return sample


class ColorAug:
    """With probability `prob`: gamma, brightness and per-channel colour
    jitter, each uniform in [0.9, 1.1], of the RGB channels in 0..255
    space, clipped."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        rgb = sample["img"][..., :3]
        gamma = rng.uniform(0.9, 1.1)
        brightness = rng.uniform(0.9, 1.1)
        colors = rng.uniform(0.9, 1.1, size=3).astype(np.float32)
        out = (rgb ** gamma) * brightness * colors[None, None, :]
        sample["img"][..., :3] = np.clip(out, 0, 255)
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


def build_train_pipeline(data_cfg, depth_scale=200.0):
    """Training augmentation: the synthetic branch of
    `gedepth_tpu.train.loop.build_train_pipeline`. It also serves the KITTI
    preset, whose dataset the port stands in for with synthetic frames of
    the KB-cropped size; the cv2 steps of the KITTI chain (ratio resize,
    pad, rotate) are not ported yet."""
    if data_cfg.dataset not in ("kitti", "synthetic"):
        raise NotImplementedError(
            f"dataset {data_cfg.dataset!r} is not ported yet")
    return Compose([RandomFlip(data_cfg.flip_prob),
                    RandomCrop(data_cfg.crop_size), ColorAug(0.5),
                    Normalize(depth_scale=depth_scale)])


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
