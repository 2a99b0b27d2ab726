"""Export CLI of the port (the counterpart of tools/export.py).

    python -m gedepth_tpu_torch.tools.export <preset> [checkpoint.npz]
        --output DIR [--batch B] [--height H --width W] [--bf16]
        [--no-flip-tta] [--self-check] [--device cuda]

The checkpoint may also come as `--checkpoint checkpoint.npz`, the JAX
tool's spelling.

Writes the serving artifact of `apis.export` to DIR: the eval step traced by
`torch.export` (model.pt2), the weights (weights.pt) and meta.json, from
`checkpoint`, a params-only `.npz` of either package, or from the port's
seeded initialisation. --self-check loads the artifact again
(`load_exported`) and runs one seeded batch (the JAX tool's input:
`default_rng(0).standard_normal`, channel 4 as |x|·30 + 1, channel 3 from
it) through it and through the eager eval step of the same weights, and
prints the largest difference. Prints one JSON line: the export and load
seconds, the artifact's bytes, the port's ops in the program and, with
--self-check, the difference. f32 runs without TF32.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def self_check_input(shape):
    """The JAX tool's seeded batch of `shape` (B, H, W, C)."""
    import numpy as np

    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if shape[-1] == 5:
        img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
        img[..., 3] = np.clip(img[..., 4], 0, None) / 200.0
    return img


def parse_args(argv=None):
    """The command line as a namespace; the checkpoint positional or
    `--checkpoint`, one of the two."""
    from gedepth_tpu_torch.configs import list_configs

    parser = argparse.ArgumentParser(description="Export GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="params-only .npz")
    parser.add_argument("--checkpoint", dest="checkpoint_flag", default=None,
                        help="the same, as the JAX tool spells it")
    parser.add_argument("--output", required=True, help="artifact directory")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="whole-model bf16 eval step (depth stays f32)")
    parser.add_argument("--no-flip-tta", action="store_true")
    parser.add_argument("--self-check", action="store_true",
                        help="reload the artifact and hold one seeded batch "
                        "against the eager eval step")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if (args.height is None) != (args.width is None):
        parser.error("--height and --width must be given together")
    flag = args.__dict__.pop("checkpoint_flag")
    if flag is not None:
        if args.checkpoint is not None:
            parser.error("give the checkpoint once: positional or "
                         "--checkpoint")
        args.checkpoint = flag
    return args


def main(argv=None):
    args = parse_args(argv)
    hw = None if args.height is None else (args.height, args.width)

    import numpy as np
    import torch

    from gedepth_tpu_torch.apis.export import (
        export_depther, load_exported, save_exported)
    from gedepth_tpu_torch.utils.env import disable_tf32

    disable_tf32()
    flip = False if args.no_flip_tta else None
    exported, weights, meta = export_depther(
        args.config, checkpoint=args.checkpoint, batch=args.batch, hw=hw,
        flip_tta=flip, bf16=args.bf16, device=args.device)
    t0 = time.perf_counter()
    save_exported(args.output, exported, weights, meta)
    line = dict(config=meta["config"], output=args.output,
                img=meta["input"]["img"], ops=meta["ops"],
                export_s=meta["export_seconds"],
                save_s=time.perf_counter() - t0,
                bytes=sum(os.path.getsize(os.path.join(args.output, f))
                          for f in os.listdir(args.output)))
    del exported, weights
    if args.self_check:
        from gedepth_tpu_torch.apis.inference import init_depther

        t0 = time.perf_counter()
        served = load_exported(args.output, device=args.device)
        line["load_s"] = time.perf_counter() - t0
        img = self_check_input(tuple(meta["input"]["img"]))
        got = served.predict(img)
        handle = init_depther(args.config, device=args.device,
                              flip_tta=flip, bf16=args.bf16,
                              checkpoint=args.checkpoint)
        cam = torch.full((img.shape[0],), meta["default_cam_height"],
                         device=handle.device)
        want = handle.eval_step(torch.from_numpy(img).to(handle.device),
                                cam).cpu().numpy()
        line.update(max_abs_diff=float(np.abs(got - want).max()),
                    depth_range=[float(got.min()), float(got.max())],
                    finite=bool(np.isfinite(got).all()))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
