"""SUN RGB-D, Cityscapes, nuScenes and a folder of images (the port of
`gedepth_tpu.data.extra_datasets`' other classes; the reference's
depth/datasets/{sunrgbd,cityscapes,nuscenes,custom}.py). No preset reads
them; `train.loop` builds them when data.dataset names one.

All are split-file driven as NYU (`data.nyu.SplitDataset`: `img depth
[extra]` a line, sorted by filename, a `None` depth kept in test mode
only), read frames by `utils.png.read_rgb` (PNG or JPEG, the port's own
decoders) and carry cam_height 0 and no PE channels:

  SUNRGBDDataset     GT PNG / depth_scale (10000), the eigen crop
  CityscapesDataset  depth = baseline·fx / ((png − 1) / 256) from the
                     16-bit disparity PNG and the camera JSON (the split's
                     third column, or the disparity path with
                     "disparity" -> "camera" and "_camera.png" ->
                     "_camera.json"); png <= 0 is invalid and 0
  NuScenesDataset    GT PNG / depth_scale (256), no crop
  CustomDepthDataset a folder's .png/.jpg/.jpeg files (any case), sorted,
                     with no GT; or a split as the others read it

Paths: an absolute frame, GT or camera path is read as it is, a relative
one under data_root (`SplitDataset._abs`).
"""
from __future__ import annotations

import json
import os

import numpy as np

from gedepth_tpu_torch.data.nyu import NYUDataset, SplitDataset
from gedepth_tpu_torch.utils.png import load_depth_png, read_png, read_rgb

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def _rgb_sample(dataset, idx, with_gt=True):
    info = dataset.infos[idx]
    sample = {"index": idx, "filename": info["filename"],
              "img": read_rgb(dataset._abs(info["filename"])),
              "cam_height": np.float32(0.0)}
    if with_gt and not dataset.test_mode and info["depth_map"] is not None:
        sample["depth_gt"] = dataset.load_gt(idx)
    return sample


class SUNRGBDDataset(NYUDataset):
    """NYU's reader with the GT in 1/10000 m; no scene classes."""

    def __init__(self, data_root, split, depth_scale=10000.0,
                 test_mode=False, min_depth=1e-3, max_depth=10.0):
        SplitDataset.__init__(self, data_root, split, depth_scale, test_mode,
                              min_depth, max_depth, eigen_crop=True)


class CityscapesDataset(SplitDataset):
    def __init__(self, data_root, split, test_mode=False, min_depth=1e-3,
                 max_depth=80.0):
        super().__init__(data_root, split, 256.0, test_mode, min_depth,
                         max_depth)

    def camera_path(self, idx):
        info = self.infos[idx]
        rel = info.get("extra")
        if rel is None:
            rel = info["depth_map"].replace("disparity", "camera").replace(
                "_camera.png", "_camera.json")
        return self._abs(rel)

    def load_gt(self, idx):
        """(H, W) float32 metres. baseline·fx is a Python float, which
        NumPy rounds to float32 before the float32 division, as the JAX
        package's arithmetic does."""
        disp_png = read_png(self._abs(self.infos[idx]["depth_map"])).astype(
            np.float32)
        with open(self.camera_path(idx)) as f:
            camera = json.load(f)
        baseline = camera["extrinsic"]["baseline"]
        fx = camera["intrinsic"]["fx"]
        disparity = (disp_png - 1.0) / 256.0
        invalid = disp_png <= 0
        disparity[invalid] = 1.0
        depth = baseline * fx / disparity
        depth[invalid] = 0.0
        return depth

    def __getitem__(self, idx):
        return _rgb_sample(self, idx)


class NuScenesDataset(SplitDataset):
    def __init__(self, data_root, split, depth_scale=256.0, test_mode=False,
                 min_depth=1e-3, max_depth=80.0):
        super().__init__(data_root, split, depth_scale, test_mode,
                         min_depth, max_depth)

    def load_gt(self, idx):
        return load_depth_png(self._abs(self.infos[idx]["depth_map"]),
                              self.depth_scale)

    def __getitem__(self, idx):
        return _rgb_sample(self, idx)


class CustomDepthDataset(SplitDataset):
    """Frames for qualitative inference: without a split, every file of
    data_root whose name ends in .png, .jpg or .jpeg (any case), sorted;
    samples carry no GT."""

    def __init__(self, data_root, split=None, depth_scale=256.0,
                 test_mode=True, min_depth=1e-3, max_depth=80.0):
        if split is not None:
            super().__init__(data_root, split, depth_scale, test_mode,
                             min_depth, max_depth)
            return
        self.data_root = data_root
        self.depth_scale = depth_scale
        self.test_mode = True
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.garg_crop = self.eigen_crop = False
        self.infos = [{"filename": f, "depth_map": None}
                      for f in sorted(os.listdir(data_root))
                      if f.lower().endswith(IMAGE_SUFFIXES)]

    def __getitem__(self, idx):
        return _rgb_sample(self, idx, with_gt=False)
