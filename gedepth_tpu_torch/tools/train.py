"""Training CLI of the port (the counterpart of tools/train.py).

    python -m gedepth_tpu_torch.tools.train <preset> [--max-iters N]
        [--work-dir DIR] [--resume-from DIR] [--eval-max-images N]
        [--seed S] [--bf16-compute] [--device cuda]

Trains the preset on one device at the preset's global batch, from the
port's seeded initialisation or from the latest checkpoint in
--resume-from (a `ckpts` directory of an earlier run), and writes to
--work-dir (default work_dirs/<preset>): `train.log.jsonl`, the best
weights as `best_abs_rel.npz` and the newest checkpoints under `ckpts/`
(`train.loop.train`). It evaluates every eval_interval steps and at the
last, on the first --eval-max-images images of the test split when given,
prints a line every log_interval steps and at each evaluation, and ends
with the best evaluation as one JSON line. f32 runs without TF32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp


def main(argv=None):
    from gedepth_tpu_torch.configs import get_config, list_configs
    from gedepth_tpu_torch.utils.env import disable_tf32

    parser = argparse.ArgumentParser(description="Train GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--work-dir", default=None,
                        help="default: <cfg.work_dir>/<preset>")
    parser.add_argument("--resume-from", default=None,
                        help="checkpoint directory: resume from its latest "
                        "step")
    parser.add_argument("--eval-max-images", type=int, default=None)
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--bf16-compute", action="store_true",
                        help="train.bf16_compute=True: forward and backward "
                        "in bf16 on f32 master weights")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    disable_tf32()
    cfg = get_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=args.seed))
    if args.bf16_compute:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    bf16_compute=True))

    from gedepth_tpu_torch.train.loop import train

    work_dir = args.work_dir or osp.join(cfg.work_dir, cfg.name)
    _, _, best = train(cfg, work_dir=work_dir,
                       max_iters=args.max_iters,
                       eval_max_images=args.eval_max_images,
                       resume_from=args.resume_from, device=args.device)
    print(json.dumps(dict(best, work_dir=work_dir)))


if __name__ == "__main__":
    main()
