"""Curves and train-time summaries of `train.log.jsonl` files (the
counterpart of tools/analyze_logs.py).

    python -m gedepth_tpu_torch.tools.analyze_logs cal_train_time \
        work_dirs/x/train.log.jsonl [...]
    python -m gedepth_tpu_torch.tools.analyze_logs plot_curve \
        work_dirs/*/train.log.jsonl --keys loss abs_rel --out curves.png

cal_train_time: the mean, fastest and slowest `time` of the train records
(each the seconds of a block of log_interval steps; the first, which holds
the start-up, counts only when it is the only one). plot_curve needs
matplotlib, imported when it runs; without it the tool says so and exits
with status 1.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_log(path):
    """The JSON records of a JSONL file, in order."""
    with open(path) as f:
        return [json.loads(line) for line in map(str.strip, f) if line]


def cal_train_time(logs):
    for path in logs:
        records = [r for r in load_log(path)
                   if r.get("mode") == "train" and "time" in r]
        if not records:
            print(f"{path}: no train records")
            continue
        times = [r["time"] for r in records[1:]] or [records[0]["time"]]
        print(f"{path}: mean iter-block time {np.mean(times):.3f}s, "
              f"fastest {min(times):.3f}s, slowest {max(times):.3f}s")


def plot_curve(logs, keys, out):
    try:
        import matplotlib
    except ImportError:
        print("plot_curve needs matplotlib, which does not import here",
              file=sys.stderr)
        return 1
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 5))
    for path in logs:
        records = load_log(path)
        for key in keys:
            xs = [r["iter"] for r in records if key in r]
            ys = [r[key] for r in records if key in r]
            if xs:
                plt.plot(xs, ys, label=f"{path}:{key}", marker=".")
    plt.xlabel("iter")
    plt.legend(fontsize=7)
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(out, dpi=150)
    print(f"saved {out}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description="Analyse train logs")
    sub = parser.add_subparsers(dest="task", required=True)
    p1 = sub.add_parser("plot_curve")
    p1.add_argument("logs", nargs="+")
    p1.add_argument("--keys", nargs="+", default=["loss"])
    p1.add_argument("--out", default="curves.png")
    p2 = sub.add_parser("cal_train_time")
    p2.add_argument("logs", nargs="+")
    args = parser.parse_args(argv)
    if args.task == "plot_curve":
        return plot_curve(args.logs, args.keys, args.out)
    cal_train_time(args.logs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
