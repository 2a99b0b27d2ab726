"""Offline KITTI ground-embedding precompute (the port of
tools/preprocess_data_kitti.py, without PIL).

    python -m gedepth_tpu_torch.tools.preprocess_data_kitti
        --data-root data/kitti --split splits/kitti_eigen_train.txt
        [--workers N] [--skip-pe] [--skip-slope]

Stage 1, for each date directory of <data-root>/input that holds
`calib_cam_to_cam.txt` and `calib_velo_to_cam.txt`: A = P2 @ R0_rect @
Tr_velo_to_cam, the analytic plane depth at camera height 1.65 over the
frame size of the date's first `*sync*` drive (read from its PNG header),
saved as input/<date>/pe/pe_165.npy.

Stage 2, for each split line with a GT: the slope classes k =
round(deg(arctan(h/gt − h/pe))) clipped to [−5, 5], 255 where gt == 0,
saved under slope_range_5_5_interval_1/<depth_rel> as an `.npz` holding
`k_img`.
"""
from __future__ import annotations

import argparse
import contextlib
import multiprocessing
import os
import os.path as osp
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from gedepth_tpu_torch.geometry.calib import (
    KITTI_CAMERA_HEIGHT, parse_kitti_calib)
from gedepth_tpu_torch.geometry.plane import (
    kitti_plane_embedding, slope_bin_gt)
from gedepth_tpu_torch.utils.png import png_size, read_png


def precompute_pe(data_root: str):
    input_root = osp.join(data_root, "input")
    for date in sorted(os.listdir(input_root)):
        date_dir = osp.join(input_root, date)
        cam_calib = osp.join(date_dir, "calib_cam_to_cam.txt")
        velo_calib = osp.join(date_dir, "calib_velo_to_cam.txt")
        if not (osp.isfile(cam_calib) and osp.isfile(velo_calib)):
            continue
        A = parse_kitti_calib(cam_calib, velo_calib)["A"]
        hw = None
        for entry in sorted(os.listdir(date_dir)):
            img0 = osp.join(date_dir, entry, "image_02", "data",
                            "0000000000.png")
            if "sync" in entry and osp.isfile(img0):
                hw = png_size(img0)
                break
        if hw is None:
            print(f"skip {date}: no sync drives found")
            continue
        pe = kitti_plane_embedding(A, *hw, KITTI_CAMERA_HEIGHT)
        out_dir = osp.join(date_dir, "pe")
        os.makedirs(out_dir, exist_ok=True)
        np.save(osp.join(out_dir, "pe_165.npy"), pe)
        print(f"{date}: pe_165.npy {pe.shape}")


def run_tasks(fn, tasks, workers, chunksize):
    """fn over tasks, in this process (workers <= 1) or in a pool of
    spawned processes, printing progress every 100."""
    print(f"{len(tasks)} tasks")
    with contextlib.ExitStack() as stack:
        if workers <= 1:
            done = map(fn, tasks)
        else:
            pool = stack.enter_context(ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")))
            done = pool.map(fn, tasks, chunksize=chunksize)
        for i, _ in enumerate(done):
            if (i + 1) % 100 == 0:
                print(f"  {i + 1}/{len(tasks)}")


def _slope_one(args):
    data_root, image_rel, depth_rel = args
    gt = read_png(osp.join(data_root, "gt_depth", depth_rel)).astype(
        np.float64) / 256.0
    date = image_rel.split("/")[0]
    pe = np.load(osp.join(data_root, "input", date, "pe",
                          "pe_165.npy")).astype(np.float32)
    k = slope_bin_gt(gt, pe, camera_height=KITTI_CAMERA_HEIGHT,
                     rounding="round")
    out_path = osp.join(data_root, "slope_range_5_5_interval_1",
                        depth_rel).replace(".png", ".npz")
    os.makedirs(osp.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, k_img=k)
    return out_path


def precompute_slope(data_root: str, split: str, workers: int):
    tasks = []
    with open(split) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2 or parts[1] == "None":
                continue
            tasks.append((data_root, parts[0], parts[1]))
    run_tasks(_slope_one, tasks, workers, chunksize=16)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", default="data/kitti")
    parser.add_argument("--split", default="splits/kitti_eigen_train.txt")
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    parser.add_argument("--skip-pe", action="store_true")
    parser.add_argument("--skip-slope", action="store_true")
    args = parser.parse_args(argv)
    if not args.skip_pe:
        precompute_pe(args.data_root)
    if not args.skip_slope:
        precompute_slope(args.data_root, args.split, args.workers)


if __name__ == "__main__":
    main()
