"""Single-image depth inference CLI of the port (the counterpart of
tools/inference.py).

    python -m gedepth_tpu_torch.tools.inference <preset> <checkpoint.npz>
        img1.png [img2.png ...] [--pe pe_165.npy] [--cam-height 1.65]
        [--out-dir inference_out] [--bf16] [--no-tta] [--npy]
        [--device cuda]

Serves each image through `init_depther` and `inference_depther` (the
preset's test pipeline, then the eval step) with the weights of
`checkpoint`, a params-only `.npz` of either package, and writes
`<stem>_depth.png`, the depth coloured by `utils.color_depth` (no PIL, no
matplotlib), and with --npy `<stem>_depth.npy`, the metric depth, into
--out-dir. --pe is the camera's raw plane embedding (`.npy`, or the `pe` of
an `.npz`), which a preset with a PE variant needs for RGB images. f32 runs
without TF32.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Single-image inference")
    parser.add_argument("config")
    parser.add_argument("checkpoint", help="params-only .npz")
    parser.add_argument("images", nargs="+", help="RGB image paths")
    parser.add_argument("--pe", default=None,
                        help="raw plane embedding .npy/.npz (PE variants)")
    parser.add_argument("--cam-height", type=float, default=None)
    parser.add_argument("--out-dir", default="inference_out")
    parser.add_argument("--bf16", action="store_true",
                        help="whole-model bf16 serving forward")
    parser.add_argument("--no-tta", action="store_true",
                        help="no flip TTA")
    parser.add_argument("--npy", action="store_true",
                        help="also write the metric depth as .npy")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from gedepth_tpu_torch.apis.inference import (
        inference_depther, init_depther)
    from gedepth_tpu_torch.utils.color_depth import colorize_depth
    from gedepth_tpu_torch.utils.env import disable_tf32
    from gedepth_tpu_torch.utils.png import write_png

    disable_tf32()
    handle = init_depther(args.config, device=args.device,
                          flip_tta=False if args.no_tta else None,
                          checkpoint=args.checkpoint, pe_path=args.pe,
                          bf16=args.bf16)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.images:
        depth = inference_depther(handle, path, cam_height=args.cam_height)
        stem = os.path.join(args.out_dir,
                            os.path.splitext(os.path.basename(path))[0])
        write_png(stem + "_depth.png", colorize_depth(depth))
        if args.npy:
            np.save(stem + "_depth.npy", depth)
        print(f"{path}: depth [{depth.min():.2f}, {depth.max():.2f}] m "
              f"-> {stem}_depth.png", flush=True)


if __name__ == "__main__":
    main()
