"""How far an f32 seg train step's grad_norm lies from the float64 step's,
in the JAX package and in the port, on the CPU: the yardstick of the seg
step's card-against-float64 checks (`chip_smoke.py` phase 38,
`test_seg_train_step_on_the_card`).

    python tests/seg_f64_distance.py [card_test|phase38]
    python tests/seg_f64_distance.py spread --seeds 0,1,2,3
    python tests/seg_f64_distance.py card --seeds 0,1,2,3

`spread`: the card test's setting with the weights and the batch seeded by
each seed in turn, both packages on the CPU (JAX's spread). `card`: the
same settings on an NVIDIA GPU, the port only (it imports no JAX), each
seed with cuDNN's autotuner off and on (`torch.backends.cudnn.benchmark`),
TF32 off, with the three parameters whose f32 gradients lie farthest from
float64, and the port's CPU step beside it.

Settings (weights and batch exactly those of the card checks):
  card_test  HRNet-W18 + OCR at head_channels 8, the port's weights seeded
             0, one batch of 2 synthetic ground scenes at 128x256 (the
             loader's seed 0);
  phase38    the preset at full width, the port's weights seeded by the
             preset's train seed (phase 38 takes them 3 steps further at
             a learning rate below 1e-6: the same point up to ~3e-7), the
             centre 176x352 of the first batch of 2 that `train()` draws
             from phase 23's KITTI tree (written here by
             `tools.make_tree` and `tools.preprocess_data_kitti`).
Prints one JSON line per setting: the grad_norm of each of the four steps
and the relative distances |f32 − float64| / float64 of each package.
"""
import copy
import dataclasses
import json
import os.path as osp
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

SEG = "ocrnet_hr18_kitti"


def card_test_setting(seed=0):
    """(model config, the port's seeded model, batch) of
    `test_seg_train_step_on_the_card` (seed 0), or with the weights and the
    loader seeded by `seed`."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    cfg = get_config(SEG)
    model_cfg = dataclasses.replace(cfg.model, head_channels=8)
    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(128, 256))
    batch = TrainLoader(SyntheticGroundDataset(size=2, height=128,
                                               width=256),
                        build_train_pipeline(data), 2, seed=seed).make_batch(0)
    model = model_cfg.build(generator=torch.Generator().manual_seed(seed))
    return model_cfg, model, batch


def phase38_setting(work):
    """(model config, the port's seeded model, batch) of phase 38's check
    at the weights `train()` starts from."""
    import chip_smoke
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.tools import preprocess_data_kitti
    from gedepth_tpu_torch.tools.make_tree import make_kitti_tree

    root = osp.join(work, "kitti")
    tree = dict(make_kitti_tree(root, chip_smoke.KITTI_TREE_SIZE, frames=5,
                                seed=chip_smoke.SEED), root=root)
    preprocess_data_kitti.main(["--data-root", root, "--split",
                                tree["train"], "--workers", "1"])
    cfg = get_config(SEG)
    cfg = cfg.replace(data=chip_smoke.tree_data(SEG, tree))
    batch = {k: v[:, 88:264, 176:528] if v.dim() >= 3 else v
             for k, v in chip_smoke.seg_batch(cfg, "cpu").items()}
    model = cfg.model.build(
        generator=torch.Generator().manual_seed(cfg.train.seed))
    return cfg.model, model, {k: v.numpy() for k, v in batch.items()}


_JAX_STEPS = {}


def port_grad_norms(model_cfg, model, batch, device="cpu", grads=None):
    """The grad_norm of one seg train step of the port from `model`'s
    weights on `batch` (numpy), in f32 and in float64, on `device`; with a
    dict `grads`, each step's gradients (on the CPU) go into it by
    dtype."""
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState, make_seg_train_step

    out = {}
    keys = ("img", "depth_gt", "cam_height")
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        m = copy.deepcopy(model).to(device, torch.float64 if name == "f64"
                                    else torch.float32)
        state = TrainState(m, toptim.make_optimizer(m),
                           toptim.lr_schedule(1e-6, 10, 0))
        metrics = make_seg_train_step(model_cfg.depth_scale)(
            state, {k: torch.from_numpy(np.ascontiguousarray(
                batch[k], dtype)).to(device) for k in keys})
        out[name] = metrics["grad_norm"].item()
        if grads is not None:
            grads[name] = {n: p.grad.detach().cpu()
                           for n, p in m.named_parameters()}
    return out


def farthest_tensors(grads, n=3):
    """The `n` parameters whose f32 gradient lies farthest from float64,
    relative in L2, among those above 1e-5 of the largest float64 norm (a
    gradient that is 0 in exact arithmetic holds rounding noise)."""
    f32, f64 = grads["f32"], grads["f64"]
    top = max(float(g.norm()) for g in f64.values())
    dist = {k: float((f32[k].double() - f64[k]).norm() / f64[k].norm())
            for k in f64 if float(f64[k].norm()) >= 1e-5 * top}
    return sorted(dist.items(), key=lambda kv: -kv[1])[:n]


def grad_norms(model_cfg, model, batch):
    """The grad_norm of one seg train step of the port and of the JAX
    package, each in f32 and in float64, from the port's `model`'s weights
    on `batch` (numpy)."""
    import jax
    import jax.numpy as jnp

    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_seg_train_step as jax_step
    from gedepth_tpu_torch.convert.from_jax import (
        flax_variables_from_state_dict)

    out = {f"port_{name}": v
           for name, v in port_grad_norms(model_cfg, model, batch).items()}
    jmodel = dataclasses.replace(jax_get_config(SEG).model,
                                 head_channels=model_cfg.head_channels
                                 ).build()
    params, stats = flax_variables_from_state_dict(model.state_dict())
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        with jax.enable_x64(name == "f64"):
            cast = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, dtype)),
                                {"params": params, "batch_stats": stats})
            tx, _ = joptim.make_optimizer(1e-6, 10, 0)
            jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                                   params=cast["params"],
                                   batch_stats=cast["batch_stats"],
                                   opt_state=tx.init(cast["params"]), tx=tx)
            key = (model_cfg.head_channels, name)
            if key not in _JAX_STEPS:   # one compile a width and dtype
                _JAX_STEPS[key] = jax_step(jmodel, model_cfg.depth_scale,
                                           donate=False)
            _, jm = _JAX_STEPS[key](
                jstate, {k: jnp.asarray(np.asarray(v, dtype))
                         for k, v in batch.items()},
                jax.random.PRNGKey(0))
            out[f"jax_{name}"] = float(jm["grad_norm"])
    for pkg in ("port", "jax"):
        out[f"{pkg}_f32_distance"] = abs(
            out[f"{pkg}_f32"] - out[f"{pkg}_f64"]) / out[f"{pkg}_f64"]
    out["f64_port_against_jax"] = abs(
        out["port_f64"] - out["jax_f64"]) / out["jax_f64"]
    return out


def _spread(values):
    return {"min": min(values), "max": max(values),
            "mean": sum(values) / len(values)}


def seeds_spread(seeds):
    """JAX's and the port's f32 distances on the CPU over `seeds`."""
    rows = []
    for seed in seeds:
        cfg, model, batch = card_test_setting(seed)
        rows.append(dict(grad_norms(cfg, model, batch), seed=seed))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"setting": "card_test", "seeds": list(seeds), **{
        f"{pkg}_f32_distance": _spread([r[f"{pkg}_f32_distance"]
                                        for r in rows])
        for pkg in ("jax", "port")}}), flush=True)


def card_spread(seeds):
    """The card's f32 distance over `seeds`, cuDNN's autotuner off and
    on; the card's name and power limit first."""
    import subprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    out = {}
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        values = []
        for seed in seeds:
            cfg, model, batch = card_test_setting(seed)
            grads, cpu_grads = {}, {}
            g = port_grad_norms(cfg, model, batch, "cuda", grads)
            values.append(abs(g["f32"] - g["f64"]) / g["f64"])
            row = {"seed": seed, "autotuner": benchmark,
                   "card_f32": g["f32"], "card_f64": g["f64"],
                   "card_f32_distance": values[-1],
                   "card_farthest": farthest_tensors(grads)}
            if not benchmark:       # the port's CPU step beside the card's
                c = port_grad_norms(cfg, model, batch, "cpu", cpu_grads)
                row["cpu_f32_distance"] = abs(c["f32"] - c["f64"]) / c["f64"]
                row["cpu_farthest"] = farthest_tensors(cpu_grads)
            print(json.dumps(row), flush=True)
        out["autotuner_on" if benchmark else "autotuner_off"] = _spread(
            values)
    print(json.dumps({"setting": "card_test", "seeds": list(seeds),
                      "device": smi, **out}), flush=True)


def main(argv):
    import os

    if argv[:1] in (["spread"], ["card"]):
        seeds = [int(s) for s in (argv[2].split(",") if argv[1:2] ==
                                  ["--seeds"] else "0,1,2,3".split(","))]
        if argv[0] == "card":
            return card_spread(seeds)
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        return seeds_spread(seeds)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    torch.set_num_threads(max(1, torch.get_num_threads()))
    for setting in argv or ("card_test", "phase38"):
        with tempfile.TemporaryDirectory() as work:
            cfg, model, batch = (card_test_setting() if setting ==
                                 "card_test" else phase38_setting(work))
            print(json.dumps(dict(grad_norms(cfg, model, batch),
                                  setting=setting)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
