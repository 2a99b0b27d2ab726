"""Training CLI of the port (the counterpart of tools/train.py).

    python -m gedepth_tpu_torch.tools.train <preset> [--max-iters N]
        [--work-dir DIR] [--seed S] [--bf16-compute] [--device cuda]

Trains the preset from the port's seeded initialisation on one device, at
the preset's global batch, and prints one line per step (loss, its parts,
the gradient norm, the LR and the step time).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    from gedepth_tpu_torch.configs import get_config, list_configs

    parser = argparse.ArgumentParser(description="Train GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--bf16-compute", action="store_true",
                        help="train.bf16_compute=True: forward and backward "
                        "in bf16 on f32 master weights")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = get_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=args.seed))

    if args.bf16_compute:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    bf16_compute=True))

    from gedepth_tpu_torch.train.loop import train

    _, history = train(cfg, work_dir=args.work_dir, max_iters=args.max_iters,
                       device=args.device)
    for r in history:
        mem = (f" peak_mem={r['peak_mem_mib']:.0f}MiB"
               if "peak_mem_mib" in r else "")
        slope = (f"loss_slope={r['loss_slope']:.6f} "
                 if "loss_slope" in r else "")
        print(f"iter {r['iter']} loss={r['loss']:.6f} "
              f"loss_depth={r['loss_depth']:.6f} {slope}"
              f"grad_norm={r['grad_norm']:.6f} lr={r['lr']:.3e} "
              f"time={r['time']:.4f}s{mem}", flush=True)


if __name__ == "__main__":
    main()
