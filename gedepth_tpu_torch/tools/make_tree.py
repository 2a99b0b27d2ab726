"""Seeded KITTI and DDAD trees on disk, in the datasets' layouts, for tests
and for driving the data path where no real frames are at hand.

    python -m gedepth_tpu_torch.tools.make_tree kitti ROOT [--seed S]
        [--frames N] [--size H,W]
    python -m gedepth_tpu_torch.tools.make_tree ddad ROOT [--seed S]
        [--frames N] [--size H,W]

KITTI: two dates of different frame sizes (the second 5 rows and 18
columns smaller, as KITTI's 2011_09_26 against 2011_09_28), each with
`calib_cam_to_cam.txt` and `calib_velo_to_cam.txt` of a forward camera
over flat ground, one drive of RGB PNGs and 16-bit GT PNGs (depth x 256),
and splits `splits/train.txt` and `splits/test.txt` in the Eigen format
(`image_rel depth_rel focal`), the test split with a `None` pair. Then run
`tools.preprocess_data_kitti` on it.

DDAD: cameras CAMERA_01 and CAMERA_05 (frame size `size`, DDAD's 1216x1936
by default), RGB PNGs under `rgb/<CAM>/`, GT `.npz` files (`depth`) under
`depth/<CAM>/`, `calib.npz` with K, the camera and lidar poses and the
frame size of all four shipped cameras, and splits whose depth paths say
`depth_val` (read as `depth`); each split holds a line of CAMERA_07, which
the dataset filters out. Then run `tools.preprocess_data_ddad --calib-npz
ROOT/calib.npz` on it.

The GT is the ground plane's depth, tilted by a slope that differs per
frame, with boxes of constant depth, on every other row (lidar-sparse); the
RGB shades it. Frames are pure functions of the seed.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from gedepth_tpu_torch.geometry.plane import plane_embedding_from_projection
from gedepth_tpu_torch.utils.png import write_png

KITTI_DATES = ("2011_09_26", "2011_09_28")
DDAD_TREE_CAMERAS = ("CAMERA_01", "CAMERA_05")
# axes of a camera (x right, y down, z forward) in a z-up frame (x forward,
# y left)
_CAM_AXES = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)


def _kitti_intrinsics(h, w, date_idx):
    f = 0.58 * w + 7.0 * date_idx
    return f, w / 2 - 3.0 * date_idx, 0.46 * h


def _scene(rng, pe, h_cam, max_depth):
    """(rgb uint8, gt float32): the tilted ground of the prior, three
    boxes, every other row kept."""
    H, W = pe.shape
    tan_k = np.tan(np.deg2rad(rng.uniform(-3, 3)))
    with np.errstate(divide="ignore", invalid="ignore"):
        gt = h_cam / (h_cam / pe + tan_k)
    gt = np.where((pe > 0) & (gt > 1.0) & (gt < max_depth), gt, 0.0)
    for _ in range(3):
        bh = int(rng.integers(H // 8, H // 3))
        bw = int(rng.integers(W // 12, W // 4))
        y0, x0 = int(rng.integers(0, H - bh)), int(rng.integers(0, W - bw))
        gt[y0:y0 + bh, x0:x0 + bw] = rng.uniform(3.0, 0.6 * max_depth)
    gt[1::2] = 0.0
    shade = np.where(gt > 0, gt / max_depth, 0.5)
    rows = np.linspace(0, 1, H)[:, None]
    cols = np.linspace(0, 1, W)[None, :]
    base = np.stack([shade * 190 + 30, rows * 170 + 40 + 0 * cols,
                     cols * 150 + 50 + 0 * rows], axis=-1)
    rgb = np.clip(base + rng.normal(0, 6, base.shape), 0, 255)
    return rgb.astype(np.uint8), gt.astype(np.float32)


def _write_split(path, lines):
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(line + "\n" for line in lines)


def make_kitti_tree(root, size=(375, 1242), frames=4, seed=0):
    """Write the KITTI tree; returns {'train': split, 'test': split}. Each
    date holds `frames` frames; the test split takes each date's last frame
    and a `None` pair, the train split the others."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for d, date in enumerate(KITTI_DATES):
        h, w = size[0] - 5 * d, size[1] - 18 * d
        drive = f"{date}_drive_{d + 1:04d}_sync"
        date_dir = osp.join(root, "input", date)
        img_dir = osp.join(date_dir, drive, "image_02", "data")
        gt_dir = osp.join(root, "gt_depth", drive, "proj_depth",
                          "groundtruth", "image_02")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        f, cx, cy = _kitti_intrinsics(h, w, d)
        with open(osp.join(date_dir, "calib_cam_to_cam.txt"), "w") as fh:
            fh.write("calib_time: 09-Jan-2012 13:57:47\n")
            fh.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
            fh.write(f"P_rect_02: {f} 0 {cx} 44.8 0 {f} {cy} 0.2 "
                     "0 0 1 0.003\n")
        with open(osp.join(date_dir, "calib_velo_to_cam.txt"), "w") as fh:
            fh.write("R: " + " ".join(str(v) for v in _CAM_AXES.ravel())
                     + "\nT: 0 0 0\n")
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        pe = plane_embedding_from_projection(
            K @ np.concatenate([_CAM_AXES, np.zeros((3, 1))], axis=1),
            h, w, 1.65)
        for i in range(frames):
            rgb, gt = _scene(rng, pe, 1.65, 80.0)
            name = f"{i:010d}.png"
            write_png(osp.join(img_dir, name), rgb)
            write_png(osp.join(gt_dir, name),
                      np.round(gt * 256).astype(np.uint16))
            line = (f"{date}/{drive}/image_02/data/{name} "
                    f"{drive}/proj_depth/groundtruth/image_02/{name} "
                    f"{f:.4f}")
            (test if i == frames - 1 else train).append(line)
        test.append(f"{date}/{drive}/image_02/data/{0:010d}.png None "
                    f"{f:.4f}")
    splits = {"train": osp.join(root, "splits", "train.txt"),
              "test": osp.join(root, "splits", "test.txt")}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


def ddad_calibration(size=(1216, 1936)):
    """{<CAM>_K, <CAM>_cam_pose, <CAM>_lidar_pose, <CAM>_hw} of the four
    shipped cameras: forward cameras at their ground heights over a lidar
    frame on the ground, pitched by a fraction of a degree each."""
    from gedepth_tpu_torch.data.ddad import DDAD_CAMERAS
    from gedepth_tpu_torch.geometry.calib import DDAD_CAMERA_HEIGHTS

    h, w = size
    out = {}
    for j, cam in enumerate(DDAD_CAMERAS):
        f = (0.55 + 0.05 * j) * w
        K = np.array([[f, 0, w / 2 + 4 * j], [0, f, 0.45 * h], [0, 0, 1.0]])
        pitch = np.deg2rad(0.3 * (j - 1.5))
        c, s = np.cos(pitch), np.sin(pitch)
        tilt = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pose = np.eye(4)
        pose[:3, :3] = tilt @ _CAM_AXES.T      # camera axes in the z-up frame
        pose[:3, 3] = (0.0, 0.0, DDAD_CAMERA_HEIGHTS[cam])
        out[f"{cam}_K"] = K
        out[f"{cam}_cam_pose"] = pose
        out[f"{cam}_lidar_pose"] = np.eye(4)
        out[f"{cam}_hw"] = np.array([h, w])
    return out


def make_ddad_tree(root, size=(1216, 1936), frames=3, seed=0):
    """Write the DDAD tree; returns {'train', 'test', 'calib'} paths. Each
    camera holds `frames` frames; the test split takes each camera's last
    frame, the train split the others."""
    from gedepth_tpu_torch.geometry.calib import DDAD_CAMERA_HEIGHTS
    from gedepth_tpu_torch.geometry.plane import ddad_plane_embedding

    rng = np.random.default_rng(seed)
    calib = ddad_calibration(size)
    os.makedirs(root, exist_ok=True)
    calib_path = osp.join(root, "calib.npz")
    np.savez(calib_path, **calib)
    train, test = [], []
    for cam in DDAD_TREE_CAMERAS:
        pe = ddad_plane_embedding(calib[f"{cam}_K"], calib[f"{cam}_cam_pose"],
                                  calib[f"{cam}_lidar_pose"], *size)
        os.makedirs(osp.join(root, "rgb", cam), exist_ok=True)
        os.makedirs(osp.join(root, "depth", cam), exist_ok=True)
        for i in range(frames):
            rgb, gt = _scene(rng, pe, DDAD_CAMERA_HEIGHTS[cam], 200.0)
            write_png(osp.join(root, "rgb", cam, f"{i:06d}.png"), rgb)
            np.savez_compressed(osp.join(root, "depth", cam, f"{i:06d}.npz"),
                                depth=gt)
            line = f"rgb/{cam}/{i:06d}.png depth_val/{cam}/{i:06d}.npz"
            (test if i == frames - 1 else train).append(line)
    for lines in (train, test):
        lines.append("rgb/CAMERA_07/000000.png depth_val/CAMERA_07/000000.npz")
    splits = {"train": osp.join(root, "splits", "train.txt"),
              "test": osp.join(root, "splits", "test.txt"),
              "calib": calib_path}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


def main(argv=None):
    parser = argparse.ArgumentParser(description="Write a seeded KITTI or "
                                     "DDAD tree")
    parser.add_argument("dataset", choices=("kitti", "ddad"))
    parser.add_argument("root")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--size", default=None, help="H,W of the frames")
    args = parser.parse_args(argv)
    kw = {"seed": args.seed}
    if args.frames:
        kw["frames"] = args.frames
    if args.size:
        kw["size"] = tuple(int(v) for v in args.size.split(","))
    make = make_kitti_tree if args.dataset == "kitti" else make_ddad_tree
    for name, path in make(args.root, **kw).items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
