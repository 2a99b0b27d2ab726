"""Host-side pipelines over sample dicts (the port of
`gedepth_tpu.data.transforms` and of the chains of
`gedepth_tpu.train.loop.build_train_pipeline` and
`gedepth_tpu.eval.evaluator.build_test_pipeline`).

Sample dict contract, as in the JAX package:

  img         (H, W, 5) float32: RGB in 0..255, the clipped PE prior, the
              raw PE ((H, W, 3) without ground embedding)
  depth_gt    (H, W) float32 metres, 0 = invalid
  pe_k_gt     (H, W) float32 slope classes 0..10, 255 = ignore
  valid_mask  (H, W) float32, made by PadToSize: 1 on the pixels of the
              frame, 0 on the padding
  cam_height, pe_ori_point, index, filename, cam_intrinsic: scalars and
              metadata

Every geometric step moves `depth_gt` and `pe_k_gt` with `img` (nearest
resampling; `pe_k_gt` pads and borders with 255, depth with 0), and
`valid_mask` where it exists. The resamplers reproduce cv2's rules without
OpenCV (`data.resample`). A random transform draws from the explicit
`np.random.Generator` it is called with, in the JAX transform's order and
number of draws, so a sample is a pure function of its seed and the two
packages consume the same stream.
"""
from __future__ import annotations

import numpy as np

from gedepth_tpu_torch.data import resample

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
    """Bottom-centred KITTI crop to (height, width): of `img` always, of the
    GT fields when crop_gt (training; evaluation reloads the GT at full
    resolution)."""

    def __init__(self, height=352, width=1216, crop_gt=True):
        self.height = height
        self.width = width
        self.crop_gt = crop_gt

    def __call__(self, sample, rng=None):
        h, w = sample["img"].shape[:2]
        top = int(h - self.height)
        left = int((w - self.width) / 2)
        sl = np.s_[top:top + self.height, left:left + self.width]
        sample["img"] = sample["img"][sl]
        if self.crop_gt:
            for key in _DEPTH_FIELDS:
                if key in sample:
                    sample[key] = sample[key][sl]
        return sample


class RandomRatioResize:
    """One draw r uniform in ratio_range; the frame becomes (int(W·r),
    int(H·r)): `img` bilinear, the GT fields nearest."""

    def __init__(self, ratio_range=(0.5, 2.0)):
        self.ratio_range = ratio_range

    def __call__(self, sample, rng):
        lo, hi = self.ratio_range
        ratio = rng.random() * (hi - lo) + lo
        h, w = sample["img"].shape[:2]
        size = (int(w * ratio), int(h * ratio))
        sample["img"] = resample.resize_linear(sample["img"], size)
        for key in _DEPTH_FIELDS:
            if key in sample:
                sample[key] = resample.resize_nearest(sample[key], size)
        return sample


class PadToSize:
    """A frame smaller than (height, width) is pasted at a random offset
    into a canvas of 0 (255 for `pe_k_gt`), and `valid_mask` marks the
    frame. Draws two integers only when it pads."""

    def __init__(self, height=352, width=1216):
        self.height = height
        self.width = width

    def __call__(self, sample, rng):
        img = sample["img"]
        h, w = img.shape[:2]
        if h >= self.height and w >= self.width:
            return sample
        th, tw = max(h, self.height), max(w, self.width)
        h_off = int(rng.integers(0, th - h + 1))
        w_off = int(rng.integers(0, tw - w + 1))
        sl = np.s_[h_off:h_off + h, w_off:w_off + w]
        canvas = np.zeros((th, tw, img.shape[2]), dtype=img.dtype)
        canvas[sl] = img
        sample["img"] = canvas
        for key in _DEPTH_FIELDS:
            if key in sample:
                field = np.full((th, tw), 255.0 if "pe" in key else 0.0,
                                dtype=sample[key].dtype)
                field[sl] = sample[key]
                sample[key] = field
        mask = np.zeros((th, tw), dtype=np.float32)
        mask[sl] = 1.0
        sample["valid_mask"] = mask
        return sample


class RandomRotate:
    """With probability `prob`, a rotation by an angle uniform in ±degree
    about the frame's centre ((W−1)/2, (H−1)/2): `img` bilinear with border
    0, the GT fields and `valid_mask` nearest with border 255 for `pe_k_gt`
    and 0 otherwise. Both draws happen whether it rotates or not."""

    def __init__(self, prob=0.5, degree=2.5):
        self.prob = prob
        self.degree = (-degree, degree) if np.isscalar(degree) else degree

    def __call__(self, sample, rng):
        rotate = rng.random() < self.prob
        degree = rng.uniform(min(*self.degree), max(*self.degree))
        if not rotate:
            return sample
        h, w = sample["img"].shape[:2]
        M = resample.rotation_matrix(((w - 1) * 0.5, (h - 1) * 0.5), -degree,
                                     1.0)
        sample["img"] = resample.warp_affine(sample["img"], M, True, 0.0)
        for key in _DEPTH_FIELDS + ("valid_mask",):
            if key in sample:
                border = 255.0 if "pe" in key else 0.0
                sample[key] = resample.warp_affine(sample[key], M, False,
                                                   border)
        return sample


class RandomFlip:
    """Horizontal flip of img, the GT fields and valid_mask with probability
    `prob`."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            for key in ("img",) + _DEPTH_FIELDS + ("valid_mask",):
                if key in sample:
                    sample[key] = np.ascontiguousarray(sample[key][:, ::-1])
            sample["flipped"] = True
        return sample


class RandomCrop:
    """Random crop of img, the GT fields and valid_mask to crop_size =
    (h, w)."""

    def __init__(self, crop_size=(352, 704)):
        self.crop_size = crop_size

    def __call__(self, sample, rng):
        ch, cw = self.crop_size
        h, w = sample["img"].shape[:2]
        off_h = int(rng.integers(0, max(h - ch, 0) + 1))
        off_w = int(rng.integers(0, max(w - cw, 0) + 1))
        sl = np.s_[off_h:off_h + ch, off_w:off_w + cw]
        for key in ("img",) + _DEPTH_FIELDS + ("valid_mask",):
            if key in sample:
                sample[key] = sample[key][sl]
        return sample


class ColorAug:
    """With probability `prob`: gamma, brightness and per-channel colour
    jitter drawn from their ranges, on the RGB channels in 0..255 space,
    clipped."""

    def __init__(self, prob=0.5, gamma_range=(0.9, 1.1),
                 brightness_range=(0.9, 1.1), color_range=(0.9, 1.1)):
        self.prob = prob
        self.gamma_range = gamma_range
        self.brightness_range = brightness_range
        self.color_range = color_range

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        rgb = sample["img"][..., :3]
        gamma = rng.uniform(*self.gamma_range)
        brightness = rng.uniform(*self.brightness_range)
        colors = rng.uniform(*self.color_range, size=3).astype(np.float32)
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


class DDADResize:
    """DDAD's resize to `shape` (384, 640): a 5-channel image's RGB by area
    averaging of its uint8 values, its two PE channels nearest (a 3-channel
    image by area averaging of its float values); with resize_gt, the valid
    (> 0) points of `depth_gt` and `pe_k_gt` scattered to their scaled
    positions, truncated, in a grid of zeros (a later point at the same
    position wins)."""

    def __init__(self, shape=(384, 640), resize_gt=True):
        self.shape = tuple(shape)
        self.resize_gt = resize_gt

    def _scatter_resize(self, x):
        h, w = x.shape
        th, tw = self.shape
        ys, xs = np.nonzero(x > 0)
        vals = x[ys, xs]
        ys = (ys * (th / h)).astype(np.int32)
        xs = (xs * (tw / w)).astype(np.int32)
        keep = (ys < th) & (xs < tw)
        out = np.zeros(self.shape, dtype=x.dtype)
        out[ys[keep], xs[keep]] = vals[keep]
        return out

    def __call__(self, sample, rng=None):
        img = sample["img"]
        size_wh = self.shape[::-1]
        if img.shape[-1] == 5:
            rgb = resample.resize_area_u8(img[..., :3].astype(np.uint8),
                                          size_wh).astype(np.float32)
            pe = resample.resize_nearest(img[..., 3:5].astype(np.float32),
                                         size_wh)
            sample["img"] = np.concatenate([rgb, pe], axis=-1)
        else:
            sample["img"] = resample.resize_area(img, size_wh)
        if self.resize_gt and "depth_gt" in sample:
            sample["depth_gt"] = self._scatter_resize(sample["depth_gt"])
            if "pe_k_gt" in sample:
                sample["pe_k_gt"] = self._scatter_resize(sample["pe_k_gt"])
        return sample


def build_train_pipeline(data_cfg, depth_scale=200.0):
    """The training chain of a DataConfig (`gedepth_tpu.train.loop`'s
    chains for 'kitti', 'ddad' and 'synthetic'); Normalize divides the PE
    channel by the model's depth_scale."""
    d = data_cfg
    tail = [RandomFlip(d.flip_prob), RandomCrop(d.crop_size), ColorAug(0.5),
            Normalize(depth_scale=depth_scale)]
    if d.dataset == "kitti":
        return Compose([KBCrop(*d.eval_size, crop_gt=True),
                        RandomRatioResize(d.ratio_range),
                        PadToSize(*d.eval_size),
                        RandomRotate(0.5, d.rotate_degree), *tail])
    if d.dataset == "ddad":
        return Compose([DDADResize(d.ddad_resize or (384, 640)),
                        RandomRatioResize(d.ratio_range),
                        PadToSize(*d.crop_size),
                        RandomRotate(0.5, d.rotate_degree), *tail])
    if d.dataset == "synthetic":
        return Compose(tail)
    raise NotImplementedError(f"dataset {d.dataset!r} is not ported")


def build_test_pipeline(data_cfg):
    """Deterministic test-time pipeline of a DataConfig
    (`gedepth_tpu.eval.evaluator.build_test_pipeline`)."""
    if data_cfg.dataset == "ddad":
        return Compose([DDADResize(data_cfg.ddad_resize or (384, 640),
                                   resize_gt=False),
                        Normalize(depth_scale=250.0)])
    if data_cfg.dataset == "kitti":
        return Compose([KBCrop(*data_cfg.eval_size, crop_gt=False),
                        Normalize(depth_scale=200.0)])
    if data_cfg.dataset == "synthetic":
        return Compose([Normalize(depth_scale=200.0)])
    raise NotImplementedError(
        f"dataset {data_cfg.dataset!r} is not ported")
