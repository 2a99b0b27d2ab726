"""Evaluation CLI of the port (the counterpart of tools/test.py).

    python -m gedepth_tpu_torch.tools.test <preset> [checkpoint.npz]
        [--state-dict FILE]
        [--max-images N] [--batch-size B] [--no-tta]
        [--aug-test --aug-ratios 0.75,1.0,1.25]
        [--slide --slide-tile H,W --slide-stride H,W]
        [--device-metrics] [--bf16] [--device cuda]
        [--options key=value ...]

Runs the `Evaluator` over the preset's test split
(`train.loop.build_eval_dataset`: KITTI or DDAD under data.data_root, or
synthetic frames) and prints the aggregate of the 9 metrics as one JSON
line. --options overrides dotted config fields (`configs.apply_options`),
e.g. `data.data_root=/data/kitti data.test_split=/data/kitti/test.txt`.
The weights come
from `checkpoint`, a params-only `.npz` of either package (the train loop's
`best_abs_rel.npz`, `tools.convert_torch_checkpoint`'s output), or from
--state-dict, a file written by `torch.save(model.state_dict(), FILE)`;
without either they are the port's seeded initialisation, and the numbers
then show that the path runs, not how good a model is. f32 runs without
TF32.
"""
from __future__ import annotations

import argparse
import json


def _pair(text):
    return tuple(int(v) for v in text.split(","))


def main(argv=None):
    from gedepth_tpu_torch.configs import (
        apply_options, get_config, list_configs)

    parser = argparse.ArgumentParser(description="Evaluate GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="params-only .npz")
    parser.add_argument("--state-dict", default=None)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--no-tta", action="store_true")
    parser.add_argument("--aug-test", action="store_true",
                        help="multi-scale TTA: ratios x flip, averaged")
    parser.add_argument("--aug-ratios", default="0.5,0.75,1.0,1.25,1.5,1.75",
                        help="comma-separated ratios for --aug-test")
    parser.add_argument("--slide", action="store_true",
                        help="sliding-window inference, overlaps averaged")
    parser.add_argument("--slide-tile", type=_pair, default=None,
                        help="H,W of the slide window (default: train crop)")
    parser.add_argument("--slide-stride", type=_pair, default=None,
                        help="H,W slide step (default: half the tile)")
    parser.add_argument("--device-metrics", action="store_true",
                        help="compute the per-image metrics on the device")
    parser.add_argument("--bf16", action="store_true",
                        help="cast the whole model to bf16 once and run the "
                        "eval forward in bf16 (depth clamp and final resize "
                        "stay f32)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    import torch

    from gedepth_tpu_torch.apis.inference import cast_params_bf16
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.train.checkpoint import load_params_only
    from gedepth_tpu_torch.train.loop import build_eval_dataset
    from gedepth_tpu_torch.utils.env import disable_tf32

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    if args.state_dict:
        model.load_state_dict(torch.load(args.state_dict, map_location="cpu",
                                         weights_only=True), strict=True)
    if args.checkpoint:
        load_params_only(args.checkpoint, model)
    model.to(torch.device(args.device))
    if args.bf16:
        cast_params_bf16(model, "all")
    elif cfg.model.bf16_scope != "none":
        cast_params_bf16(model, cfg.model.bf16_scope)
    ratios = (tuple(float(r) for r in args.aug_ratios.split(","))
              if args.aug_test else ())
    evaluator = Evaluator(model, build_eval_dataset(cfg), cfg.data,
                          batch_size=args.batch_size,
                          flip_tta=False if args.no_tta else None,
                          ms_ratios=ratios,
                          device_metrics=args.device_metrics, bf16=args.bf16,
                          mode="slide" if args.slide else None,
                          slide_tile=args.slide_tile,
                          slide_stride=args.slide_stride)
    agg, per_image = evaluator.run(max_images=args.max_images, progress=50)
    print(json.dumps(dict(agg, images=len(per_image), config=cfg.name,
                          bf16=args.bf16)))


if __name__ == "__main__":
    main()
