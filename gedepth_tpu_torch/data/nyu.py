"""NYU Depth v2 (the port of `gedepth_tpu.data.extra_datasets`'
`_SplitDataset` and `NYUDataset`; the reference's depth/datasets/nyu.py).

Split-file driven: `img_rel depth_rel [focal]` per line. A `None` depth is
dropped outside test mode and kept (as no GT) in test mode; the infos are
sorted by filename. A sample holds the RGB frame (`utils.png.read_rgb`:
PNG here, JPEG through PIL where it imports), cam_height 0 (indoor frames
have no ground-plane prior: no PE channels), and outside test mode the GT,
a 16-bit PNG divided by depth_scale (1000: millimetres).

Paths: a split path, a frame or a GT that is absolute is read as it is; a
relative one is joined to data_root (a split that does not exist there is
tried as given). So a toolbox split whose names begin with "/" is read from
the file system's root, as in the JAX package.

scene_classes=True (outside test mode) labels each sample with its scene:
the first path component up to its first '_' ('bedroom_0001' ->
'bedroom'), numbered in the order of the sorted filenames.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from gedepth_tpu_torch.utils.png import load_depth_png, read_rgb


class SplitDataset:
    """The split-file machinery the toolbox's datasets share."""

    def __init__(self, data_root, split, depth_scale, test_mode, min_depth,
                 max_depth, garg_crop=False, eigen_crop=False):
        self.data_root = data_root
        self.depth_scale = depth_scale
        self.test_mode = test_mode
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.garg_crop = garg_crop
        self.eigen_crop = eigen_crop
        self.infos = self._load_split(split)

    def _load_split(self, split):
        infos = []
        path = split if osp.isabs(split) else osp.join(self.data_root, split)
        if not osp.exists(path):
            path = split
        with open(path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if not parts[0]:
                    continue
                depth_rel = parts[1] if len(parts) > 1 else None
                if depth_rel == "None":
                    if not self.test_mode:
                        continue
                    depth_rel = None
                info = {"filename": parts[0], "depth_map": depth_rel}
                if len(parts) > 2:
                    info["extra"] = parts[2]
                infos.append(info)
        infos.sort(key=lambda x: x["filename"])
        return infos

    def __len__(self):
        return len(self.infos)

    def _abs(self, rel):
        return rel if osp.isabs(rel) else osp.join(self.data_root, rel)


class NYUDataset(SplitDataset):
    def __init__(self, data_root, split, depth_scale=1000.0, test_mode=False,
                 min_depth=1e-3, max_depth=10.0, scene_classes=False):
        super().__init__(data_root, split, depth_scale, test_mode,
                         min_depth, max_depth, eigen_crop=True)
        self.scene_classes = scene_classes
        if scene_classes and not test_mode:
            class_ids = {}
            for info in self.infos:
                scene = info["filename"].lstrip("/").split("/")[0]
                name = scene.split("_")[0]
                info["scene_class"] = class_ids.setdefault(name,
                                                           len(class_ids))
            self.scene_class_names = list(class_ids)

    def load_gt(self, idx):
        return load_depth_png(self._abs(self.infos[idx]["depth_map"]),
                              self.depth_scale)

    def __getitem__(self, idx):
        info = self.infos[idx]
        sample = {"index": idx, "filename": info["filename"],
                  "img": read_rgb(self._abs(info["filename"])),
                  "cam_height": np.float32(0.0)}
        if not self.test_mode and info["depth_map"] is not None:
            sample["depth_gt"] = self.load_gt(idx)
        if "scene_class" in info:
            sample["scene_class"] = np.int32(info["scene_class"])
        return sample
