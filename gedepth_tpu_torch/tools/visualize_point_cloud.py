"""Back-project depth maps to point clouds and write them as PLY files (the
counterpart of tools/visualize_point_cloud.py).

    python -m gedepth_tpu_torch.tools.visualize_point_cloud <preset>
        [--checkpoint ckpt.npz] [--indices 0 1 2] [--out-dir pc_out]
        [--render] [--device cuda] [--options key=value ...]

For each test-split image: the predicted depth (`init_depther` without
flip-TTA, then `inference_depther`) and, for a 5-channel sample, the raw PE
prior clipped to [0, max_depth], back-projected through the sample's
intrinsics (KITTI's 2011_09_26 camera when it has none) into
`<index>_<pred|pe>.ply`. --render also draws a scatter plot with
matplotlib, imported only then; without it the render is skipped with a
message.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def backproject(depth, K):
    """(H, W) depth and 3x3 intrinsics -> (N, 3) camera-frame points of the
    pixels with depth > 0."""
    h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    z = depth.reshape(-1)
    valid = z > 0
    uv1 = np.stack([us.reshape(-1), vs.reshape(-1),
                    np.ones(h * w)], axis=0)[:, valid]
    pts = (np.linalg.inv(K) @ uv1) * z[valid]
    return pts.T


def write_ply(path, points, color=(180, 180, 180)):
    """ASCII PLY of `points` (N, 3), each vertex in one colour."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{color[0]} {color[1]} {color[2]}\n")


def render_scatter(path, clouds):
    """A 3-D scatter of (points, label, colour) clouds into `path`; False
    when matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 4))
    ax = fig.add_subplot(111, projection="3d")
    for (pts, label, color) in clouds:
        sel = pts[:: max(len(pts) // 4000, 1)]
        ax.scatter(sel[:, 0], sel[:, 2], -sel[:, 1], s=0.5, label=label,
                   color=color, alpha=0.5)
    ax.set_xlabel("x"), ax.set_ylabel("z"), ax.legend()
    plt.tight_layout()
    plt.savefig(path, dpi=130)
    plt.close(fig)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description="Depth to point clouds")
    parser.add_argument("config")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--indices", nargs="+", type=int, default=[0])
    parser.add_argument("--out-dir", default="pc_out")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from gedepth_tpu_torch.apis.inference import (
        inference_depther, init_depther)
    from gedepth_tpu_torch.configs import apply_options, get_config
    from gedepth_tpu_torch.geometry.calib import KITTI_CAM_INTRINSICS_3x3
    from gedepth_tpu_torch.train.loop import build_eval_dataset
    from gedepth_tpu_torch.utils.env import disable_tf32

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    test_ds = build_eval_dataset(cfg)
    handle = init_depther(cfg, device=args.device,
                          checkpoint=args.checkpoint, flip_tta=False)
    os.makedirs(args.out_dir, exist_ok=True)
    for idx in args.indices:
        sample = test_ds[idx]
        K = sample.get("cam_intrinsic")
        K = (np.asarray(K)[:3, :3] if K is not None
             else KITTI_CAM_INTRINSICS_3x3["2011_09_26"])
        pred = inference_depther(handle, sample["img"],
                                 float(sample.get("cam_height", 1.65)))
        clouds = [(backproject(pred, K), "pred", "tab:blue")]
        if sample["img"].shape[-1] == 5:
            pe = np.clip(sample["img"][..., 4], 0, cfg.model.max_depth)
            clouds.append((backproject(pe[:pred.shape[0], :pred.shape[1]],
                                       K), "pe", "tab:green"))
        for pts, label, _ in clouds:
            write_ply(osp.join(args.out_dir, f"{idx:05d}_{label}.ply"), pts)
        if args.render and not render_scatter(
                osp.join(args.out_dir, f"{idx:05d}.png"), clouds):
            print("--render needs matplotlib, which does not import here; "
                  "wrote the PLY files only", flush=True)
        print(f"index {idx}: wrote {len(clouds)} clouds", flush=True)


if __name__ == "__main__":
    main()
