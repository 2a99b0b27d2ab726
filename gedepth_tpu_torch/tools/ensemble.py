"""Weighted mean of saved depth predictions, written as 16-bit PNGs (the
counterpart of tools/ensemble.py, without PIL).

    python -m gedepth_tpu_torch.tools.ensemble --inputs runA/preds runB/preds
        [--weights 0.5 0.5] --out ensemble_out [--scale 256]

Every `.npy` of the first input directory is read from each directory,
weighted (equal weights by default) and summed in float64, then written as
`<name>.png`: clip(sum · scale, 0, 65535) as uint16 (`utils.png`).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np


def ensemble(inputs, out, weights=None, scale=256.0):
    """Write the ensembled PNGs into `out`; returns the names read."""
    from gedepth_tpu_torch.utils.png import write_png

    weights = weights or [1.0 / len(inputs)] * len(inputs)
    if len(weights) != len(inputs):
        raise ValueError(f"{len(weights)} weights for {len(inputs)} inputs")
    os.makedirs(out, exist_ok=True)
    names = sorted(n for n in os.listdir(inputs[0]) if n.endswith(".npy"))
    for name in names:
        acc = None
        for d, w in zip(inputs, weights):
            arr = np.load(osp.join(d, name)).astype(np.float64) * w
            acc = arr if acc is None else acc + arr
        out16 = np.clip(acc * scale, 0, 65535).astype(np.uint16)
        write_png(osp.join(out, name.replace(".npy", ".png")), out16)
    return names


def main(argv=None):
    parser = argparse.ArgumentParser(description="Ensemble depth dumps")
    parser.add_argument("--inputs", nargs="+", required=True,
                        help="directories of per-image .npy predictions")
    parser.add_argument("--weights", nargs="+", type=float, default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--scale", type=float, default=256.0,
                        help="multiplier before uint16 quantisation")
    args = parser.parse_args(argv)
    names = ensemble(args.inputs, args.out, args.weights, args.scale)
    print(f"wrote {len(names)} ensembled maps to {args.out}")


if __name__ == "__main__":
    main()
