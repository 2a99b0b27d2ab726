"""KITTI-shaped synthetic data: a toy camera over flat ground, one raw
request for serving, and `SyntheticGroundDataset` for training (the numpy
generator of `gedepth_tpu.data.synthetic`, carried over)."""
from __future__ import annotations

import numpy as np

from gedepth_tpu_torch.geometry.plane import (
    clip_pe_for_input, plane_embedding_from_projection, sanitize_pe_raw,
    slope_bin_gt, slope_gt_to_class)


def toy_projection(h, w):
    """(3, 4) projection of a forward-looking camera over flat ground, the
    camera of `gedepth_tpu.data.synthetic`."""
    fx = 0.6 * w
    K = np.array([[fx, 0, w / 2], [0, fx, 0.42 * h], [0, 0, 1.0]])
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)
    return K @ np.concatenate([R, np.zeros((3, 1))], axis=1)


def synthetic_request(rng, height=375, width=1242, camera_height=1.65):
    """One raw request: an RGB image (0..255) and the finite raw PE of the
    toy camera, both (height, width[, 3]) float32."""
    pe = plane_embedding_from_projection(
        toy_projection(height, width), height, width, camera_height)
    rows = np.linspace(0, 1, height, dtype=np.float32)[:, None, None]
    rgb = 60 + 120 * rows + rng.normal(0, 25, (height, width, 3))
    return (np.clip(rgb, 0, 255).astype(np.float32), sanitize_pe_raw(pe))


class SyntheticGroundDataset:
    """Geometrically consistent training samples: each index gives a scene
    with a ground plane tilted by a slope in [−4°, 4°], three boxes of
    constant depth, lidar-sparse GT (every H//64-th row, every 2nd column),
    a shaded RGB image and the slope-class GT. Samples are dicts:

      img         (H, W, 5) float32: RGB 0..255, clipped PE, raw PE
      depth_gt    (H, W) float32 metres, 0 = no measurement
      pe_k_gt     (H, W) float32 slope classes 0..10, 255 = ignore
      cam_height  float32; index; pe_ori_point

    use_pe=False (a model without ground embedding) gives `img` (H, W, 3)
    and neither pe_k_gt nor pe_ori_point. `seed` separates the scenes of one
    dataset from another's (the eval split uses seed 1).
    """

    camera_height = 1.65
    min_depth = 1e-3

    def __init__(self, size=64, height=352, width=1216, depth_scale=200.0,
                 max_depth=80.0, use_pe=True, seed=0):
        self.size = size
        self.use_pe, self.seed = use_pe, seed
        self.height, self.width = height, width
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        self._pe = plane_embedding_from_projection(
            toy_projection(height, width), height, width, self.camera_height)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        H, W, pe, h = self.height, self.width, self._pe, self.camera_height

        tan_k = np.tan(np.deg2rad(rng.uniform(-4, 4)))
        with np.errstate(divide="ignore", invalid="ignore"):
            gt = h / (h / pe + tan_k)
        gt = np.where((gt > self.min_depth) & (gt < self.max_depth)
                      & (pe > 0), gt, 0.0)
        for _ in range(3):
            bh = int(rng.integers(H // 8, H // 3))
            bw = int(rng.integers(W // 12, W // 4))
            y0 = int(rng.integers(0, H - bh))
            x0 = int(rng.integers(0, W - bw))
            gt[y0:y0 + bh, x0:x0 + bw] = rng.uniform(3.0, 60.0)
        keep = np.zeros((H, W), dtype=bool)
        keep[::max(H // 64, 1), ::2] = True
        gt = np.where(keep, gt, 0.0).astype(np.float32)

        shade = np.where(gt > 0, gt / self.max_depth, 0.5)
        base = np.stack(
            [shade * 200 + 30,
             np.linspace(0, 1, H)[:, None].repeat(W, 1) * 180 + 40,
             np.linspace(0, 1, W)[None, :].repeat(H, 0) * 160 + 50], axis=-1)
        rgb = np.clip(base + rng.normal(0, 8, size=(H, W, 3)), 0, 255)

        sample = {"depth_gt": gt, "cam_height": np.float32(h), "index": idx}
        if not self.use_pe:
            return dict(sample, img=rgb.astype(np.float32))
        pe_raw = sanitize_pe_raw(pe)
        img = np.concatenate(
            [rgb.astype(np.float32),
             clip_pe_for_input(pe, self.depth_scale)[..., None],
             pe_raw[..., None]], axis=-1)
        return dict(sample, img=img,
                    pe_k_gt=slope_gt_to_class(slope_bin_gt(gt, pe, h)),
                    pe_ori_point=np.float32(pe_raw[-1, -1]))
