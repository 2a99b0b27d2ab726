"""KITTI Eigen dataset (the port of `gedepth_tpu.data.kitti`).

Split-file driven: `image_rel depth_rel focal` per line; a `None` depth is
filtered in train and test mode alike and counted in `invalid_depth_num`,
and the infos are sorted by filename. A sample holds:

  * the RGB frame `<data_root>/input/<image_rel>` (PNG, `utils.png`),
  * the date's plane prior `input/<date>/pe/pe_165.npy` (made by
    `tools.preprocess_data_kitti`), loaded once a date, as the clipped and
    the raw PE channels of `img`,
  * the GT `<data_root>/gt_depth/<depth_rel>` (16-bit PNG / depth_scale),
  * the slope classes `slope_range_5_5_interval_1/<depth_rel>` as `.npz`
    (+5 to class ids, 260 back to the ignore index 255; resized nearest to
    the GT when its shape differs),
  * cam_height 1.65 and the date's `cam_intrinsic`.

Frames differ in size by date (375x1242, 370x1224, 374x1238, 376x1241).
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from gedepth_tpu_torch.data.resample import resize_nearest
from gedepth_tpu_torch.geometry.calib import (
    KITTI_CAM_INTRINSICS_4COL, KITTI_CAMERA_HEIGHT)
from gedepth_tpu_torch.geometry.plane import (
    clip_pe_for_input, sanitize_pe_raw)
from gedepth_tpu_torch.utils.png import load_depth_png, read_rgb


class KittiDataset:
    def __init__(self, data_root, split, img_dir="input", ann_dir="gt_depth",
                 depth_scale=256.0, use_pe=True, load_slope_gt=True,
                 pe_clip=200.0, test_mode=False, min_depth=1e-3,
                 max_depth=80.0, garg_crop=True, eigen_crop=False):
        self.data_root = data_root
        self.img_dir = osp.join(data_root, img_dir)
        self.ann_dir = osp.join(data_root, ann_dir)
        self.depth_scale = depth_scale
        self.use_pe = use_pe
        self.load_slope_gt = load_slope_gt and not test_mode
        self.pe_clip = pe_clip
        self.test_mode = test_mode
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.garg_crop = garg_crop
        self.eigen_crop = eigen_crop
        self.infos = self._load_split(split)
        self._pe_cache = {}

    def _load_split(self, split):
        infos, invalid = [], 0
        with open(split) as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts[0]:
                    continue
                depth_rel = parts[1] if len(parts) > 1 else "None"
                if depth_rel == "None":
                    invalid += 1
                    continue
                infos.append({"filename": parts[0], "depth_map": depth_rel})
        infos.sort(key=lambda x: x["filename"])
        self.invalid_depth_num = invalid
        return infos

    def __len__(self):
        return len(self.infos)

    def _load_pe(self, date):
        if date not in self._pe_cache:
            self._pe_cache[date] = np.load(
                osp.join(self.img_dir, date, "pe", "pe_165.npy")
            ).astype(np.float32)
        return self._pe_cache[date]

    def gt_path(self, idx):
        return osp.join(self.ann_dir, self.infos[idx]["depth_map"])

    def load_gt(self, idx):
        return load_depth_png(self.gt_path(idx), self.depth_scale)

    def __getitem__(self, idx):
        info = self.infos[idx]
        img = read_rgb(osp.join(self.img_dir, info["filename"]))
        date = info["filename"].split("/")[0]
        sample = {
            "index": idx,
            "filename": info["filename"],
            "cam_height": np.float32(KITTI_CAMERA_HEIGHT),
            "cam_intrinsic": np.asarray(
                KITTI_CAM_INTRINSICS_4COL.get(date), dtype=np.float32),
        }
        if self.use_pe:
            pe_raw = sanitize_pe_raw(self._load_pe(date))
            pe_in = clip_pe_for_input(pe_raw, self.pe_clip)
            sample["img"] = np.concatenate(
                [img, pe_in[..., None], pe_raw[..., None]], axis=-1)
            sample["pe_ori_point"] = np.float32(pe_raw[-1, -1])
        else:
            sample["img"] = img
        if not self.test_mode:
            depth_gt = self.load_gt(idx)
            sample["depth_gt"] = depth_gt
            if self.load_slope_gt:
                slope_path = self.gt_path(idx).replace(".png", ".npz").replace(
                    "gt_depth", "slope_range_5_5_interval_1")
                with np.load(slope_path) as f:
                    k = f["k_img"].astype(np.float32) + 5
                k[k == 260] = 255
                if k.shape != depth_gt.shape:
                    k = resize_nearest(k, depth_gt.shape[::-1])
                sample["pe_k_gt"] = k
        return sample
