"""Evaluation CLI of the port (the counterpart of tools/test.py).

    python -m gedepth_tpu_torch.tools.test <preset> [--state-dict FILE]
        [--max-images N] [--batch-size B] [--no-tta]
        [--aug-test --aug-ratios 0.75,1.0,1.25]
        [--slide --slide-tile H,W --slide-stride H,W]
        [--device-metrics] [--bf16] [--device cuda]

Runs the `Evaluator` over the preset's test split and prints the aggregate
of the 9 metrics as one JSON line. The repository holds no KITTI data, so
the split is synthetic (`train.loop.build_eval_dataset`). Without
--state-dict the weights are the port's seeded initialisation: the numbers
then show that the path runs, not how good a model is. --state-dict takes a
file written by `torch.save(model.state_dict(), FILE)`, for instance of
`convert.state_dict_from_flax`.
"""
from __future__ import annotations

import argparse
import json


def _pair(text):
    return tuple(int(v) for v in text.split(","))


def main(argv=None):
    from gedepth_tpu_torch.configs import get_config, list_configs

    parser = argparse.ArgumentParser(description="Evaluate GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
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
    args = parser.parse_args(argv)

    import torch

    from gedepth_tpu_torch.apis.inference import cast_params_bf16
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    cfg = get_config(args.config)
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    if args.state_dict:
        model.load_state_dict(torch.load(args.state_dict, map_location="cpu",
                                         weights_only=True), strict=True)
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
