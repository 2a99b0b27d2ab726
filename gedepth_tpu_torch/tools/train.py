"""Training CLI of the port (the counterpart of tools/train.py).

    python -m gedepth_tpu_torch.tools.train <preset> [--max-iters N]
        [--work-dir DIR] [--resume-from DIR] [--load-backbone-from NPZ]
        [--eval-max-images N] [--seed S] [--bf16-compute] [--device cuda]
        [--multihost] [--options key=value ...]
    python -m gedepth_tpu_torch.tools.train --list
    python -m torch.distributed.run --nproc_per_node N \
        -m gedepth_tpu_torch.tools.train <preset> --multihost ...

Trains the preset on one device at the preset's global batch, from the
port's seeded initialisation or from the latest checkpoint in
--resume-from (a `ckpts` directory of an earlier run), and writes to
--work-dir (default work_dirs/<preset>): `train.log.jsonl`, the best
weights as `best_abs_rel.npz` (`best_miou.npz` for the seg preset
`ocrnet_hr18_kitti`) and the newest checkpoints under `ckpts/`
(`train.loop.train`). It evaluates every eval_interval steps and at the
last, on the first --eval-max-images images of the test split when given,
prints a line every log_interval steps and at each evaluation, and ends
with the best evaluation as one JSON line. --options overrides dotted
config fields (`configs.apply_options`), e.g. `data.data_root=/data/kitti
data.train_split=/data/kitti/splits/train.txt`, or `data.dataset=` one of
kitti, ddad, nyu, sunrgbd, cityscapes, nuscenes, custom or synthetic
(`train.loop`); --list prints the presets.
--load-backbone-from overlays the backbone of a stage-1 ground-mask model
(`tools.pretrain_pe_mask`'s `pe_mask_backbone.npz`, either package) before
the first step. --multihost joins the process group that `torchrun`
describes in the environment (one process per card, NCCL; gloo with
--device cpu): every process trains its rows of the global batch and
evaluates its shard of the test split, and process 0 alone prints and
writes. f32 runs without TF32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp


def main(argv=None):
    from gedepth_tpu_torch.configs import (
        apply_options, get_config, list_configs)
    from gedepth_tpu_torch.utils.env import disable_tf32

    parser = argparse.ArgumentParser(description="Train GEDepth (PyTorch)")
    parser.add_argument("config", nargs="?", choices=list_configs())
    parser.add_argument("--work-dir", default=None,
                        help="default: <cfg.work_dir>/<preset>")
    parser.add_argument("--resume-from", default=None,
                        help="checkpoint directory: resume from its latest "
                        "step")
    parser.add_argument("--load-backbone-from", default=None,
                        help="stage-1 backbone .npz to overlay before the "
                        "first step")
    parser.add_argument("--eval-max-images", type=int, default=None)
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--bf16-compute", action="store_true",
                        help="train.bf16_compute=True: forward and backward "
                        "in bf16 on f32 master weights")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--multihost", action="store_true",
                        help="join the torchrun process group first")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    parser.add_argument("--list", action="store_true", dest="list_configs",
                        help="print the presets and exit")
    args = parser.parse_args(argv)
    if args.list_configs:
        print("\n".join(list_configs()))
        return
    if args.config is None:
        parser.error("a preset is required (see --list)")

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    if args.seed is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=args.seed))
    if args.bf16_compute:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    bf16_compute=True))

    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.data.loader import stop_worker_server
    from gedepth_tpu_torch.train.loop import train

    device = (parallel.init_from_env(args.device) if args.multihost
              else args.device)
    work_dir = args.work_dir or osp.join(cfg.work_dir, cfg.name)
    try:
        _, _, best = train(cfg, work_dir=work_dir,
                           max_iters=args.max_iters,
                           eval_max_images=args.eval_max_images,
                           resume_from=args.resume_from,
                           load_backbone_from=args.load_backbone_from,
                           device=device)
        if parallel.is_main():
            print(json.dumps(dict(best, work_dir=work_dir,
                                  world=parallel.world(),
                                  backend=parallel.backend())))
    finally:
        parallel.shutdown()
        stop_worker_server()


if __name__ == "__main__":
    main()
