"""Evaluation CLI of the port (the counterpart of tools/test.py).

    python -m gedepth_tpu_torch.tools.test <preset> [checkpoint.npz]
        [--state-dict FILE]
        [--max-images N] [--batch-size B] [--no-tta]
        [--aug-test --aug-ratios 0.75,1.0,1.25]
        [--slide --slide-tile H,W --slide-stride H,W]
        [--device-metrics] [--bf16] [--device cuda] [--multihost]
        [--show-dir DIR] [--format-only [--format-dir DIR]]
        [--options key=value ...]
    python -m torch.distributed.run --nproc_per_node N \
        -m gedepth_tpu_torch.tools.test <preset> ... --multihost

Runs the `Evaluator` over the preset's test split
(`train.loop.build_eval_dataset`: KITTI, DDAD, NYU, SUN RGB-D, Cityscapes
or nuScenes under data.data_root, a custom folder of frames, or synthetic
frames) and prints the aggregate of the 9 metrics as one JSON line. A
custom folder (`data.dataset=custom`) has no GT: evaluate it with
--format-only (asking for metrics raises KeyError 'depth_gt', as in the
JAX package). --options overrides dotted config fields (`configs.apply_options`),
e.g. `data.data_root=/data/kitti data.test_split=/data/kitti/test.txt`.
The weights come
from `checkpoint`, a params-only `.npz` of either package (the train loop's
`best_abs_rel.npz`, `tools.convert_torch_checkpoint`'s output), or from
--state-dict, a file written by `torch.save(model.state_dict(), FILE)`;
without either they are the port's seeded initialisation, and the numbers
then show that the path runs, not how good a model is. --multihost joins
the process group that `torchrun` describes in the environment (NCCL; gloo
with --device cpu): each process evaluates its strided shard of the split
(--max-images of it at most), the per-image metrics of every process are
gathered before the aggregate, and process 0 prints it. f32 runs without
TF32. The seg preset, which predicts no depth, is refused (its evaluation
is `eval.SegEvaluator` in `tools.train`'s loop, as in the JAX package).

--show-dir writes each prediction coloured by `utils.color_depth` as
`<name>_depth.png`; --format-only writes each as a 16-bit PNG of depth ×
data.gt_depth_scale, clipped to 0..65535 (the reference's format_results),
into --format-dir and computes no metrics. <name> is the image's path in
the split with '/' turned into '_' and no extension (synthetic frames:
`synthetic_<index>`); under --multihost each process writes its own shard.
"""
from __future__ import annotations

import argparse
import json
import os


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
    parser.add_argument("--multihost", action="store_true",
                        help="join the torchrun process group first")
    parser.add_argument("--show-dir", default=None,
                        help="write colourised depth maps here")
    parser.add_argument("--format-only", action="store_true",
                        help="write uint16 depth PNGs, no metrics")
    parser.add_argument("--format-dir", default="format_results")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    import torch

    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.utils.env import disable_tf32

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    if cfg.model.arch == "seg":
        parser.error("the seg preset predicts no depth: tools.train "
                     "evaluates it in its loop (eval.SegEvaluator)")
    device = (parallel.init_from_env(args.device) if args.multihost
              else torch.device(args.device))
    try:
        _evaluate(args, cfg, device)
    finally:
        parallel.shutdown()


def _evaluate(args, cfg, device):
    import torch

    from gedepth_tpu_torch import parallel
    from gedepth_tpu_torch.apis.inference import cast_params_bf16
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.train.checkpoint import load_params_only
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    if args.state_dict:
        model.load_state_dict(torch.load(args.state_dict, map_location="cpu",
                                         weights_only=True), strict=True)
    if args.checkpoint:
        load_params_only(args.checkpoint, model)
    model.to(device)
    if args.bf16:
        cast_params_bf16(model, "all")
    elif cfg.model.bf16_scope != "none":
        cast_params_bf16(model, cfg.model.bf16_scope)
    ratios = (tuple(float(r) for r in args.aug_ratios.split(","))
              if args.aug_test else ())
    dataset = build_eval_dataset(cfg)
    evaluator = Evaluator(model, dataset, cfg.data,
                          batch_size=args.batch_size,
                          flip_tta=False if args.no_tta else None,
                          ms_ratios=ratios,
                          device_metrics=args.device_metrics, bf16=args.bf16,
                          mode="slide" if args.slide else None,
                          slide_tile=args.slide_tile,
                          slide_stride=args.slide_stride)
    on_prediction = None
    if args.format_only or args.show_dir:
        def on_prediction(index, pred):
            write_outputs(args, cfg, dataset, index, pred)

    agg, per_image = evaluator.run(max_images=args.max_images, progress=50,
                                   on_prediction=on_prediction,
                                   compute_metrics=not args.format_only)
    if args.format_only:
        print(f"wrote formatted predictions to {args.format_dir}",
              flush=True)
        return
    if parallel.is_main():
        print(json.dumps(dict(agg, images=len(per_image), config=cfg.name,
                              bf16=args.bf16, world=parallel.world(),
                              backend=parallel.backend())))


def output_stem(dataset, index):
    """An image's name in the outputs: its path in the split, '/' as '_',
    without extension."""
    if hasattr(dataset, "infos"):
        name = dataset.infos[index]["filename"].replace("/", "_")
        return os.path.splitext(name)[0]
    return f"synthetic_{index:05d}"


def write_outputs(args, cfg, dataset, index, pred):
    """The --format-only and --show-dir files of one prediction (H, W)."""
    import numpy as np

    from gedepth_tpu_torch.utils.color_depth import colorize_depth
    from gedepth_tpu_torch.utils.png import write_png

    stem = output_stem(dataset, index)
    if args.format_only:
        os.makedirs(args.format_dir, exist_ok=True)
        out16 = np.clip(pred * cfg.data.gt_depth_scale, 0,
                        65535).astype(np.uint16)
        write_png(os.path.join(args.format_dir, stem + ".png"), out16)
    if args.show_dir:
        os.makedirs(args.show_dir, exist_ok=True)
        write_png(os.path.join(args.show_dir, stem + "_depth.png"),
                  colorize_depth(pred))


if __name__ == "__main__":
    main()
