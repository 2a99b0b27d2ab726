"""Convert a reference GEDepth/DepthFormer `.pth` (or an official Swin
ImageNet checkpoint) into a params-only `.npz` that `tools.test`,
`tools.compat_check` and `init_depther(checkpoint=...)` of either package
read (the counterpart of tools/convert_torch_checkpoint.py).

    python -m gedepth_tpu_torch.tools.convert_torch_checkpoint \
        <ckpt.pth> <preset> <out.npz> [--official-swin]
        [--binsformer-release] [--simipu] [--options key=value ...]

The preset's model (its fields overridden by --options) is built from its
seeded initialisation and the file is loaded into it
(`convert.from_pth.convert_checkpoint_file`); what the file does not give
keeps that initialisation and is listed. --official-swin: the file holds an
official Swin backbone only. --binsformer-release: the file is a released
BinsFormer checkpoint, whose pixel-decoder keys are nested one level deeper
(`convert.from_pth.binsformer_release_remap`). --simipu: the file is a
SimIPU pretraining checkpoint, whose `img_backbone.*` keys become the
backbone's (`convert.from_pth.simipu_backbone_extract`); the rest of the
model keeps its initialisation. Runs on the CPU.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    from gedepth_tpu_torch.configs import list_configs

    parser = argparse.ArgumentParser(
        description="Convert a reference .pth to a params-only .npz")
    parser.add_argument("checkpoint")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("out")
    parser.add_argument("--official-swin", action="store_true",
                        help="the file uses the official Swin key names "
                        "(backbone only; the rest keeps the seeded "
                        "initialisation)")
    parser.add_argument("--binsformer-release", action="store_true",
                        help="apply the released-BinsFormer key fix "
                        "(decode_head.transformer_decoder.decoder.X -> "
                        "decode_head.transformer_decoder.X)")
    parser.add_argument("--simipu", action="store_true",
                        help="keep the img_backbone of a SimIPU pretraining "
                        "checkpoint, as backbone.* (applied after "
                        "--binsformer-release, before --official-swin)")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    return parser.parse_args(argv)


def main(argv=None):
    from gedepth_tpu_torch.configs import apply_options, get_config
    from gedepth_tpu_torch.utils.env import disable_tf32

    args = parse_args(argv)

    import torch

    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file
    from gedepth_tpu_torch.train.checkpoint import save_params_only

    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    _, report = convert_checkpoint_file(
        args.checkpoint, model, official_swin=args.official_swin,
        binsformer_release=args.binsformer_release, simipu=args.simipu)
    for name, what in (("unmapped_torch_keys", "torch keys had no mapping"),
                       ("unused_torch_keys", "torch keys map to modules "
                        "this model lacks"),
                       ("missing_params", "model parameters kept the "
                        "seeded initialisation"),
                       ("missing_stats", "BatchNorm statistics kept their "
                        "initial values")):
        if report.get(name):
            print(f"[warn] {len(report[name])} {what}, e.g. "
                  f"{report[name][:5]}")
    save_params_only(args.out, model)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
