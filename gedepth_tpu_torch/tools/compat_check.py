"""Per-checkpoint windowed_compat acceptance: pick the window radius (the
counterpart of tools/compat_check.py).

The compat presets sample the reference parameter tree inside a window of
+-R level pixels around each query's grid centre, displacements clamped
(models/hahi.py, 'windowed_compat'). How far a trained checkpoint's
reference points and offsets reach decides what the clamp costs, so the
check runs per checkpoint: per radius, the mean abs-rel depth delta of the
compat forward in f32, and of the preset's bf16 scope, against the exact
(mmcv) forward on the same weights, and the attention mass the clamp moved
in each deformable-attention layer; then the smallest radius whose delta
clears the budget (1e-3 for the parity preset, the released checkpoints'
abs-rel budget).

    python -m gedepth_tpu_torch.tools.compat_check converted.npz \
        [--config gedepth_adaptive_kitti_parity] [--radii 4,5,6,8] \
        [--budget 1e-3] [--images 2] [--seed 0] [--device cuda | --cpu]
        [--options key=value ...]

The inputs are synthetic KITTI-shaped scenes made from --seed: where a
checkpoint's offsets sample depends on the weights, the query grids and the
input statistics, not on real pixels. Runs without TF32.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from gedepth_tpu_torch.apis.inference import cast_params_bf16
from gedepth_tpu_torch.models.hahi import MSDeformAttention
from gedepth_tpu_torch.train.checkpoint import load_params_only

LAYERS = ("self_attn", "multi_att")


def synthetic_scenes(images, h, w, seed):
    """(images, h, w, 5) inputs of the JAX tool: normal RGB, |normal|·0.3
    clipped PE, |normal|·30 + 1 raw PE."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((images, h, w, 5)).astype(np.float32)
    img[..., 3] = np.abs(img[..., 3]) * 0.3
    img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
    return img


def _set_window_radius(model, radius):
    for m in model.modules():
        if isinstance(m, MSDeformAttention):
            m.window_radius = radius


def compat_check(cfg, checkpoint, radii=(4, 5, 6, 8), budget=1e-3,
                 images=2, seed=0, device="cuda"):
    """The table of the check for a windowed_compat preset `cfg` and a
    params-only `.npz`: one dict per radius with `radius`, `delta_f32`,
    `delta_scope` (None when the preset's bf16_scope is 'none') and
    `clamp_mass` ({'self_attn': ..., 'multi_att': ...}, from the f32
    forward). A delta is mean(|d − ref| / max(ref, min_depth)) over every
    pixel of every image, ref the exact f32 depth. `budget` is only
    carried into the rows (`clears_f32`, `clears_scope`)."""
    mc = cfg.model
    if mc.neck_sampling != "windowed_compat":
        raise ValueError(f"{cfg.name} samples {mc.neck_sampling!r}: the "
                         "check needs a windowed_compat preset")
    device = torch.device(device)
    scope = mc.bf16_scope
    h, w = cfg.data.eval_size
    img = torch.from_numpy(synthetic_scenes(images, h, w, seed)).to(device)
    ch = torch.full((images,), mc.default_cam_height, device=device)

    def build(weights=None, **over):
        m = dataclasses.replace(mc, **over).build(
            generator=torch.Generator().manual_seed(0))
        if weights is None:
            load_params_only(checkpoint, m)
        else:
            m.load_state_dict(weights, strict=True)
        return m.to(device)

    @torch.inference_mode()
    def depth(m):
        return m.predict_depth(img, ch)[..., 0].float().cpu().numpy()

    exact = build(neck_sampling="bilinear", bf16_scope="none")
    ref = depth(exact)
    weights = exact.state_dict()
    del exact
    compat = build(weights, bf16_scope="none")
    mixed = None
    if scope != "none":
        mixed = cast_params_bf16(build(weights), scope)
    del weights

    def delta(d):
        return float(np.mean(np.abs(d - ref)
                             / np.maximum(ref, mc.min_depth)))

    rows = []
    for radius in radii:
        _set_window_radius(compat, radius)
        row = {"radius": radius, "delta_f32": delta(depth(compat)),
               "clamp_mass": {name: float(getattr(compat.neck, name)
                                          .compat_clamp_mass)
                              for name in LAYERS},
               "delta_scope": None}
        if mixed is not None:
            _set_window_radius(mixed, radius)
            row["delta_scope"] = delta(depth(mixed))
        row["clears_f32"] = row["delta_f32"] < budget
        row["clears_scope"] = (row["delta_scope"] is not None
                               and row["delta_scope"] < budget)
        rows.append(row)
    return rows


def recommendation(rows, config_name, scope, budget):
    """The RECOMMENDATION line of the JAX tool for these rows: the smallest
    radius whose delta clears the budget, in the preset's scope when it has
    one."""
    rec_f32 = next((r["radius"] for r in rows if r["clears_f32"]), None)
    rec_scope = next((r["radius"] for r in rows if r["clears_scope"]), None)
    if scope != "none":
        if rec_scope is not None:
            return (f"RECOMMENDATION: serve {config_name} with "
                    f"neck_window_radius={rec_scope} (bf16_scope={scope}); "
                    f"delta clears {budget:g}.")
        return (f"RECOMMENDATION: no tested radius clears {budget:g} at "
                f"bf16_scope={scope}; try larger --radii or f32 (best f32 "
                f"R: {rec_f32}).")
    if rec_f32 is not None:
        return f"RECOMMENDATION: neck_window_radius={rec_f32} (f32)."
    return (f"RECOMMENDATION: no tested radius clears {budget:g}; try "
            "larger --radii or the exact config.")


def format_table(rows, scope):
    head = (f"{'R':>3}  {'delta_f32':>10}  "
            f"{'delta_' + (scope if scope != 'none' else 'n/a'):>20}  "
            "clamp_mass(self/cross)")
    lines = [head]
    for r in rows:
        ds = ("-" if r["delta_scope"] is None
              else f"{r['delta_scope']:.6g}")
        lines.append(f"{r['radius']:>3}  {r['delta_f32']:>10.6g}  {ds:>20}  "
                     + "/".join(f"{r['clamp_mass'][n]:.4f}"
                                for n in LAYERS))
    return "\n".join(lines)


def parse_args(argv=None):
    """The command line as a namespace (`--cpu` is `--device cpu`)."""
    from gedepth_tpu_torch.configs import list_configs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="params-only .npz")
    ap.add_argument("--config", default="gedepth_adaptive_kitti_parity",
                    choices=list_configs())
    ap.add_argument("--radii", default="4,5,6,8")
    ap.add_argument("--budget", type=float, default=1e-3)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="--device cpu, as the JAX tool "
                    "spells it")
    ap.add_argument("--options", nargs="*", default=None,
                    help="dotted config overrides, e.g. "
                    "model.embed_dims=32 data.eval_size=64,128")
    return ap.parse_args(argv)


def main(argv=None):
    from gedepth_tpu_torch.configs import apply_options, get_config
    from gedepth_tpu_torch.utils.env import disable_tf32

    args = parse_args(argv)
    disable_tf32()
    cfg = apply_options(get_config(args.config), args.options)
    h, w = cfg.data.eval_size
    print(f"config {args.config}  ckpt {args.checkpoint}  "
          f"{args.images}x{h}x{w}  budget {args.budget:g}", flush=True)
    rows = compat_check(cfg, args.checkpoint,
                        [int(r) for r in args.radii.split(",")],
                        args.budget, args.images, args.seed, args.device)
    print(format_table(rows, cfg.model.bf16_scope))
    print(recommendation(rows, args.config, cfg.model.bf16_scope,
                         args.budget), flush=True)
    return rows


if __name__ == "__main__":
    main()
