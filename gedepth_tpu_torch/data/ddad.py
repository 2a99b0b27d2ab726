"""DDAD dataset (the port of `gedepth_tpu.data.ddad`).

Split-file driven: `image_path depth_npz_path` per line, kept when the
depth path's camera directory is one of `cameras`, `depth_val` read as
`depth`, sorted by filename. A sample holds:

  * the RGB frame (PNG, `utils.png`; relative paths under data_root),
  * the camera's plane prior `<data_root>/pe_public_debug/<CAMERA>/
    ddad_pe.npz` (`pe`, made by `tools.preprocess_data_ddad`), loaded once
    a camera, as the clipped and the raw PE channels of `img`,
  * the GT, the dense float `depth` of the depth `.npz`,
  * the slope classes `*_slope_public_debug.npz` beside it (255 kept as the
    ignore index, the rest +5 to class ids),
  * the camera's ground height and intrinsics.

The evaluation protocol has no crop and no flip-TTA; predictions are
upsampled to the GT with align_corners=True (`eval.evaluator`).
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from gedepth_tpu_torch.geometry.calib import DDAD_CAMERA_HEIGHTS
from gedepth_tpu_torch.geometry.plane import (
    clip_pe_for_input, sanitize_pe_raw)
from gedepth_tpu_torch.utils.png import read_rgb

DDAD_CAMERAS = ("CAMERA_01", "CAMERA_05", "CAMERA_06", "CAMERA_09")

DDAD_CAM_INTRINSICS_4COL = {
    "CAMERA_01": [[2.1815303e03, 0.0, 9.2802191e02, 0],
                  [0.0, 2.1816035e03, 6.1595679e02, 0],
                  [0.0, 0.0, 1.0, 0]],
    "CAMERA_05": [[1.0570685e03, 0.0, 9.6468347e02, 0],
                  [0.0, 1.0559746e03, 5.8866125e02, 0],
                  [0.0, 0.0, 1.0, 0]],
    "CAMERA_06": [[1.0607557e03, 0.0, 9.4655847e02, 0],
                  [0.0, 1.0592549e03, 6.1140710e02, 0],
                  [0.0, 0.0, 1.0, 0]],
    "CAMERA_09": [[1.0634580e03, 0.0, 9.4466577e02, 0],
                  [0.0, 1.0652224e03, 6.1269843e02, 0],
                  [0.0, 0.0, 1.0, 0]],
}


class DDADDataset:
    def __init__(self, data_root, split, cameras=DDAD_CAMERAS,
                 depth_scale=250.0, use_pe=True, load_slope_gt=True,
                 pe_clip=250.0, test_mode=False, min_depth=1e-3,
                 max_depth=200.0):
        self.data_root = data_root
        self.cameras = tuple(cameras)
        self.depth_scale = depth_scale
        self.use_pe = use_pe
        self.load_slope_gt = load_slope_gt and not test_mode
        self.pe_clip = pe_clip
        self.test_mode = test_mode
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.garg_crop = False
        self.eigen_crop = False
        self.infos = self._load_split(split)
        self._pe_cache = {}

    def _load_split(self, split):
        infos = []
        with open(split) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) < 2:
                    continue
                if parts[1].split("/")[-2] not in self.cameras:
                    continue
                infos.append({
                    "filename": parts[0],
                    "depth_map": parts[1].replace("depth_val", "depth"),
                })
        infos.sort(key=lambda x: x["filename"])
        return infos

    def __len__(self):
        return len(self.infos)

    def _load_pe(self, camera):
        if camera not in self._pe_cache:
            path = osp.join(self.data_root, "pe_public_debug", camera,
                            "ddad_pe.npz")
            with np.load(path) as f:
                self._pe_cache[camera] = f["pe"].astype(np.float32)
        return self._pe_cache[camera]

    def gt_path(self, idx):
        p = self.infos[idx]["depth_map"]
        return p if osp.isabs(p) else osp.join(self.data_root, p)

    def load_gt(self, idx):
        with np.load(self.gt_path(idx)) as f:
            return f["depth"].astype(np.float32)

    def __getitem__(self, idx):
        info = self.infos[idx]
        camera = info["depth_map"].split("/")[-2]
        img_path = info["filename"]
        if not osp.isabs(img_path):
            img_path = osp.join(self.data_root, img_path)
        sample = {
            "index": idx,
            "filename": info["filename"],
            "cam_height": np.float32(DDAD_CAMERA_HEIGHTS[camera]),
            "cam_intrinsic": np.asarray(
                DDAD_CAM_INTRINSICS_4COL[camera], dtype=np.float32),
        }
        img = read_rgb(img_path)
        if self.use_pe:
            pe_raw = sanitize_pe_raw(self._load_pe(camera))
            pe_in = clip_pe_for_input(pe_raw, self.pe_clip)
            sample["img"] = np.concatenate(
                [img, pe_in[..., None], pe_raw[..., None]], axis=-1)
            sample["pe_ori_point"] = np.float32(pe_raw[-1, -1])
        else:
            sample["img"] = img
        if not self.test_mode:
            sample["depth_gt"] = self.load_gt(idx)
            if self.load_slope_gt:
                slope_path = self.gt_path(idx).replace(
                    ".npz", "_slope_public_debug.npz")
                with np.load(slope_path) as f:
                    k = f["k_img"].astype(np.float32)
                ignore = k == 255
                k = k + 5
                k[ignore] = 255
                sample["pe_k_gt"] = k
        return sample
