"""Seeded KITTI, DDAD, NYU, Cityscapes, nuScenes, SUN RGB-D and custom
trees on disk, in the datasets' layouts, for tests and for driving the data
path where no real frames are at hand.

    python -m gedepth_tpu_torch.tools.make_tree DATASET ROOT [--seed S]
        [--frames N] [--size H,W]

DATASET is kitti, ddad, nyu, cityscapes, nuscenes, sunrgbd or custom.

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

NYU: scene directories (`bedroom_0004`, `kitchen_0011`, `bedroom_0017`)
of `frames` frames each, 480x640 by default: `rgb_<i>.png` and the 16-bit
GT `sync_depth_<i>.png` (millimetres), and splits `splits/nyu_train.txt`
and `splits/nyu_test.txt` (`rgb depth focal`, relative to ROOT, where the
NYU presets look for them); the test split takes each scene's last frame,
the train split the others and a `None` pair, which the dataset drops.

Cityscapes (1024x2048): cities `aachen` and `bochum`, `frames` frames
each, as `leftImg8bit/<split>/<city>/<city>_000000_<i>_leftImg8bit.png`,
the 16-bit disparity `disparity/.../..._disparity.png` (p = 256·d + 1, 0
where invalid: the sky, the top tenth; facades of 15-70 m behind the
ground) and `camera/.../..._camera.json` (baseline, fx);
splits `splits/cityscapes_{train,test}.txt`, every other line without the
third column (the camera path then follows from the disparity path).

nuScenes (900x1600) and SUN RGB-D (530x730): JPEG frames copied from the
committed fixtures of `gedepth_tpu_torch/testdata/jpeg` (so that no JPEG
encoder is needed; `tools.make_jpeg_fixtures` wrote them with PIL), which
also come at 45x80 and 53x73; `--size` takes those sizes only. nuScenes:
`samples/CAM_FRONT/<token>.jpg` and the lidar-sparse GT
`depth/CAM_FRONT/<token>.png` (depth x 256); SUN RGB-D:
`kv2/kinect2data/<scene>/image/<i>.jpg` and `.../depth_bfx/<i>.png`
(depth x 10000, so at most 6.5 m); splits
`splits/{nuscenes,sunrgbd}_{train,test}.txt`.

custom: a folder of frames for qualitative inference: `frame_a.png` at
`size` (375x1242 by default), `frame_b.jpg` (the 530x730 SUN RGB-D
fixture), `frame_c.JPG` (a 61x83 4:2:2 fixture) and a `notes.txt` the
dataset skips.

The KITTI, DDAD and nuScenes GT is the ground plane's depth, tilted by a
slope that differs per frame, with boxes of constant depth, on every other
row (lidar-sparse), Cityscapes' the same, dense; the NYU and SUN RGB-D GT
is a room (a floor and a back wall, boxes), dense but for a few holes, as
a Kinect leaves them; the RGB of the PNG frames shades it. Frames are pure
functions of the seed.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil

import numpy as np

from gedepth_tpu_torch.geometry.plane import plane_embedding_from_projection
from gedepth_tpu_torch.tools.make_jpeg_fixtures import (
    DEFAULT_DIR as JPEG_FIXTURES)
from gedepth_tpu_torch.utils.png import write_png

KITTI_DATES = ("2011_09_26", "2011_09_28")
DDAD_TREE_CAMERAS = ("CAMERA_01", "CAMERA_05")
# axes of a camera (x right, y down, z forward) in a z-up frame (x forward,
# y left)
_CAM_AXES = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64)


def _kitti_intrinsics(h, w, date_idx):
    f = 0.58 * w + 7.0 * date_idx
    return f, w / 2 - 3.0 * date_idx, 0.46 * h


def _scene(rng, pe, h_cam, max_depth, sparse=True):
    """(rgb uint8, gt float32): the tilted ground of the prior, three
    boxes, every other row kept (all with sparse=False)."""
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
    if sparse:
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


NYU_SCENES = ("bedroom_0004", "kitchen_0011", "bedroom_0017")
NYU_FOCAL = 518.8579


def _room(rng, h, w):
    """(rgb uint8, gt float32) of an indoor frame: a floor rising to a back
    wall at 4-9 m, two boxes nearer, a few holes of 0."""
    wall = rng.uniform(4.0, 9.0)
    rows = np.arange(h, dtype=np.float64)[:, None]
    horizon = rng.uniform(0.35, 0.55) * h
    floor = 1.6 * NYU_FOCAL / np.maximum(rows - horizon, 1e-3) * (h / 480)
    gt = np.where(rows > horizon, np.minimum(floor, wall), wall)
    gt = np.broadcast_to(gt, (h, w)).copy()
    for _ in range(2):
        bh, bw = int(rng.integers(h // 6, h // 3)), int(rng.integers(
            w // 8, w // 4))
        y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        gt[y0:y0 + bh, x0:x0 + bw] = np.minimum(
            gt[y0:y0 + bh, x0:x0 + bw], rng.uniform(0.8, 3.5))
    gt = np.clip(gt, 0.5, 9.5)
    for _ in range(3):
        hh, hw = int(rng.integers(4, h // 10)), int(rng.integers(4, w // 10))
        y0, x0 = int(rng.integers(0, h - hh)), int(rng.integers(0, w - hw))
        gt[y0:y0 + hh, x0:x0 + hw] = 0.0
    shade = np.where(gt > 0, gt / 10.0, 0.5)
    cols = np.linspace(0, 1, w)[None, :]
    base = np.stack([shade * 180 + 40, 200 - shade * 120 + 0 * cols,
                     cols * 140 + 60 + 0 * shade], axis=-1)
    rgb = np.clip(base + rng.normal(0, 5, base.shape), 0, 255)
    return rgb.astype(np.uint8), gt.astype(np.float32)


def make_nyu_tree(root, size=(480, 640), frames=4, seed=0):
    """Write the NYU tree; returns {'train': split, 'test': split}."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for scene in NYU_SCENES:
        os.makedirs(osp.join(root, scene), exist_ok=True)
        for i in range(frames):
            rgb, gt = _room(rng, *size)
            img, depth = f"{scene}/rgb_{i:05d}.png", \
                f"{scene}/sync_depth_{i:05d}.png"
            write_png(osp.join(root, img), rgb)
            write_png(osp.join(root, depth),
                      np.round(gt * 1000).astype(np.uint16))
            line = f"{img} {depth} {NYU_FOCAL}"
            (test if i == frames - 1 else train).append(line)
    train.append(f"{NYU_SCENES[0]}/rgb_{0:05d}.png None {NYU_FOCAL}")
    splits = {"train": osp.join(root, "splits", "nyu_train.txt"),
              "test": osp.join(root, "splits", "nyu_test.txt")}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


CITYSCAPES_CITIES = ("aachen", "bochum")
# a Cityscapes camera JSON's baseline (m) and focal length (px) at 1024x2048
CITYSCAPES_BASELINE, CITYSCAPES_FX = 0.209313, 2262.52
# the JPEG frames of each dataset, by frame size
JPEG_FRAMES = {
    "nuscenes": {(900, 1600): ("nuscenes_0.jpg", "nuscenes_1.jpg"),
                 (45, 80): ("nuscenes_small_0.jpg", "nuscenes_small_1.jpg")},
    "sunrgbd": {(530, 730): ("sunrgbd_0.jpg", "sunrgbd_1.jpg"),
                (53, 73): ("sunrgbd_small_0.jpg", "sunrgbd_small_1.jpg")},
}


def _forward_camera(h, w, f, h_cam):
    """(K, ground-plane depth) of a level forward camera at h_cam over flat
    ground."""
    K = np.array([[f, 0, w / 2], [0, f, 0.48 * h], [0, 0, 1.0]])
    with np.errstate(divide="ignore"):          # the horizon's row
        pe = plane_embedding_from_projection(
            K @ np.concatenate([_CAM_AXES, np.zeros((3, 1))], axis=1), h, w,
            h_cam)
    return K, pe


def _jpeg_frames(dataset, size):
    frames = JPEG_FRAMES[dataset]
    if tuple(size) not in frames:
        raise ValueError(f"{dataset} frames are copies of the committed "
                         f"JPEG fixtures, of sizes {sorted(frames)}; "
                         f"not {tuple(size)}")
    return [osp.join(JPEG_FIXTURES, name) for name in frames[tuple(size)]]


def make_cityscapes_tree(root, size=(1024, 2048), frames=2, seed=0):
    """Write the Cityscapes tree; returns {'train': split, 'test': split}.
    Each city holds `frames` frames; the test split takes each city's last
    frame, the train split the others."""
    rng = np.random.default_rng(seed)
    h, w = size
    fx = CITYSCAPES_FX * w / 2048
    _, pe = _forward_camera(h, w, fx, 1.22)
    train, test = [], []
    for city in CITYSCAPES_CITIES:
        for i in range(frames):
            part = "test" if i == frames - 1 else "train"
            stem = f"{part}/{city}/{city}_000000_{19 + i:06d}"
            paths = {kind: f"{kind}/{stem}_{kind}.{ext}" for kind, ext in (
                ("leftImg8bit", "png"), ("disparity", "png"),
                ("camera", "json"))}
            for rel in paths.values():
                os.makedirs(osp.dirname(osp.join(root, rel)), exist_ok=True)
            rgb, depth = _scene(rng, pe, 1.22, 80.0, sparse=False)
            # facades of 15-70 m behind the ground, the top tenth sky
            facade = np.repeat(rng.uniform(15.0, 70.0, 16), -(-w // 16))[:w]
            rows = np.arange(h)[:, None] >= h // 10
            depth = np.where((depth > 0) | ~rows, depth,
                             facade[None, :]).astype(np.float32)
            disparity = np.where(
                depth > 0, CITYSCAPES_BASELINE * fx / np.maximum(depth, 1e-6)
                * 256 + 1, 0)
            write_png(osp.join(root, paths["leftImg8bit"]), rgb)
            write_png(osp.join(root, paths["disparity"]),
                      np.round(np.minimum(disparity, 65535)).astype(
                          np.uint16))
            with open(osp.join(root, paths["camera"]), "w") as f:
                json.dump({"extrinsic": {"baseline": CITYSCAPES_BASELINE,
                                         "pitch": 0.0, "roll": 0.0,
                                         "yaw": 0.0, "x": 1.7, "y": 0.1,
                                         "z": 1.22},
                           "intrinsic": {"fx": fx, "fy": fx, "u0": w / 2,
                                         "v0": 0.48 * h}}, f)
            line = f"{paths['leftImg8bit']} {paths['disparity']}"
            if i % 2 == 0:
                line += f" {paths['camera']}"
            (test if part == "test" else train).append(line)
    splits = {"train": osp.join(root, "splits", "cityscapes_train.txt"),
              "test": osp.join(root, "splits", "cityscapes_test.txt")}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


def make_nuscenes_tree(root, size=(900, 1600), frames=3, seed=0):
    """Write the nuScenes tree; returns {'train': split, 'test': split}:
    `frames` front-camera samples, the last one the test split's."""
    rng = np.random.default_rng(seed)
    h, w = size
    jpegs = _jpeg_frames("nuscenes", size)
    _, pe = _forward_camera(h, w, 1266.4 * w / 1600, 1.51)
    os.makedirs(osp.join(root, "samples", "CAM_FRONT"), exist_ok=True)
    os.makedirs(osp.join(root, "depth", "CAM_FRONT"), exist_ok=True)
    train, test = [], []
    for i in range(frames):
        token = f"n008-2018-08-01-15-16-36-0400__CAM_FRONT__{1533151603512404 + 50000 * i}"
        img, depth = (f"samples/CAM_FRONT/{token}.jpg",
                      f"depth/CAM_FRONT/{token}.png")
        shutil.copyfile(jpegs[i % len(jpegs)], osp.join(root, img))
        _, gt = _scene(rng, pe, 1.51, 80.0)
        write_png(osp.join(root, depth), np.round(gt * 256).astype(np.uint16))
        (test if i == frames - 1 else train).append(f"{img} {depth}")
    splits = {"train": osp.join(root, "splits", "nuscenes_train.txt"),
              "test": osp.join(root, "splits", "nuscenes_test.txt")}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


SUNRGBD_SCENES = ("000002_2014-05-26_14-23-37_260595134347_rgbf000103",
                  "000014_2014-05-26_14-32-05_260595134347_rgbf000034")


def make_sunrgbd_tree(root, size=(530, 730), frames=2, seed=0):
    """Write the SUN RGB-D tree; returns {'train': split, 'test': split}:
    two Kinect v2 scenes of `frames` frames, each scene's last frame the
    test split's."""
    rng = np.random.default_rng(seed)
    jpegs = _jpeg_frames("sunrgbd", size)
    train, test = [], []
    for s, scene in enumerate(SUNRGBD_SCENES):
        base = osp.join("kv2", "kinect2data", scene)
        os.makedirs(osp.join(root, base, "image"), exist_ok=True)
        os.makedirs(osp.join(root, base, "depth_bfx"), exist_ok=True)
        for i in range(frames):
            img, depth = (f"{base}/image/{i:07d}.jpg",
                          f"{base}/depth_bfx/{i:07d}.png")
            shutil.copyfile(jpegs[(s + i) % len(jpegs)], osp.join(root, img))
            _, gt = _room(rng, *size)
            write_png(osp.join(root, depth),
                      np.round(np.minimum(gt, 6.5) * 10000).astype(np.uint16))
            (test if i == frames - 1 else train).append(f"{img} {depth}")
    splits = {"train": osp.join(root, "splits", "sunrgbd_train.txt"),
              "test": osp.join(root, "splits", "sunrgbd_test.txt")}
    _write_split(splits["train"], train)
    _write_split(splits["test"], test)
    return splits


def make_custom_tree(root, size=(375, 1242), frames=None, seed=0):
    """Write the custom folder; returns {'root': root, 'frames': [names]}
    in the order the dataset lists them. `frames` is ignored (the folder
    holds one frame of each kind)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    _, pe = _forward_camera(*size, 0.58 * size[1], 1.65)
    rgb, _ = _scene(rng, pe, 1.65, 80.0)
    write_png(osp.join(root, "frame_a.png"), rgb)
    shutil.copyfile(osp.join(JPEG_FIXTURES, "sunrgbd_0.jpg"),
                    osp.join(root, "frame_b.jpg"))
    shutil.copyfile(osp.join(JPEG_FIXTURES, "q50_422.jpg"),
                    osp.join(root, "frame_c.JPG"))
    with open(osp.join(root, "notes.txt"), "w") as f:
        f.write("not a frame\n")
    return {"root": root,
            "frames": ["frame_a.png", "frame_b.jpg", "frame_c.JPG"]}


WRITERS = {"kitti": make_kitti_tree, "ddad": make_ddad_tree,
           "nyu": make_nyu_tree, "cityscapes": make_cityscapes_tree,
           "nuscenes": make_nuscenes_tree, "sunrgbd": make_sunrgbd_tree,
           "custom": make_custom_tree}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Write a seeded dataset "
                                     "tree")
    parser.add_argument("dataset", choices=tuple(WRITERS))
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
    for name, path in WRITERS[args.dataset](args.root, **kw).items():
        print(f"{name}: {path}")


if __name__ == "__main__":
    main()
