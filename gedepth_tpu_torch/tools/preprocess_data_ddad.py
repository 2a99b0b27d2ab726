"""Offline DDAD ground-embedding precompute from a calibration `.npz` (the
port of the `--calib-npz` route of tools/preprocess_data_ddad.py; the route
through TRI's dgp SDK is not ported).

    python -m gedepth_tpu_torch.tools.preprocess_data_ddad
        --data-root data/DDAD --calib-npz calib.npz
        --split splits/ddad_train_split.txt [--workers N]
        [--skip-pe] [--skip-slope]

Stage 1, for each camera of DDAD_CAMERAS: the plane depth of
A = K4 @ inv(cam_pose) @ lidar_pose over the camera's frame, from the
`.npz` entries `<CAM>_K` (3, 3), `<CAM>_cam_pose` (4, 4),
`<CAM>_lidar_pose` (4, 4) and `<CAM>_hw` (2,), saved as
<data-root>/pe_public_debug/<CAM>/ddad_pe.npz (`pe`).

Stage 2, for each split line of a shipped camera: the slope classes of the
depth `.npz` at the camera's height (1.56, 1.57, 1.53, 1.53 m), truncated
toward zero (`slope_bin_gt(rounding='trunc')`), saved beside it as
`*_slope_public_debug.npz` (`k_img`).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from gedepth_tpu_torch.data.ddad import DDAD_CAMERAS
from gedepth_tpu_torch.geometry.calib import DDAD_CAMERA_HEIGHTS
from gedepth_tpu_torch.geometry.plane import (
    ddad_plane_embedding, slope_bin_gt)
from gedepth_tpu_torch.tools.preprocess_data_kitti import run_tasks


def precompute_pe_from_npz(data_root: str, calib_npz: str):
    data = dict(np.load(calib_npz))
    for cam in DDAD_CAMERAS:
        h, w = data[f"{cam}_hw"].astype(int)
        pe = ddad_plane_embedding(data[f"{cam}_K"], data[f"{cam}_cam_pose"],
                                  data[f"{cam}_lidar_pose"], h, w)
        out = osp.join(data_root, "pe_public_debug", cam)
        os.makedirs(out, exist_ok=True)
        np.savez_compressed(osp.join(out, "ddad_pe.npz"), pe=pe)
        print(f"{cam}: ddad_pe.npz {pe.shape}")


def _slope_one(args):
    data_root, depth_rel = args
    cam = depth_rel.split("/")[-2]
    gt_path = (depth_rel if osp.isabs(depth_rel)
               else osp.join(data_root, depth_rel))
    with np.load(gt_path) as f:
        gt = f["depth"]
    with np.load(osp.join(data_root, "pe_public_debug", cam,
                          "ddad_pe.npz")) as f:
        pe = f["pe"]
    k = slope_bin_gt(gt, pe, camera_height=DDAD_CAMERA_HEIGHTS[cam],
                     rounding="trunc")
    out_path = gt_path.replace(".npz", "_slope_public_debug.npz")
    np.savez_compressed(out_path, k_img=k)
    return out_path


def precompute_slope(data_root: str, split: str, workers: int):
    tasks = []
    with open(split) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2 or parts[1] == "None":
                continue
            if parts[1].split("/")[-2] not in DDAD_CAMERAS:
                continue
            tasks.append((data_root, parts[1].replace("depth_val", "depth")))
    run_tasks(_slope_one, tasks, workers, chunksize=8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", default="data/DDAD")
    parser.add_argument("--calib-npz", default=None,
                        help="per-camera K, poses and frame size (required "
                        "for stage 1)")
    parser.add_argument("--split", default="splits/ddad_train_split.txt")
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    parser.add_argument("--skip-pe", action="store_true")
    parser.add_argument("--skip-slope", action="store_true")
    args = parser.parse_args(argv)
    if not args.skip_pe:
        if not args.calib_npz:
            parser.error("--calib-npz is required for the plane prior "
                         "(the dgp route is not ported)")
        precompute_pe_from_npz(args.data_root, args.calib_npz)
    if not args.skip_slope:
        precompute_slope(args.data_root, args.split, args.workers)


if __name__ == "__main__":
    main()
