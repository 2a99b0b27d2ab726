"""How far an f32 seg train step's grad_norm lies from the float64 step's,
in the JAX package and in the port, on the CPU: the yardstick of the seg
step's card-against-float64 checks (`chip_smoke.py` phase 38,
`test_seg_train_step_on_the_card`).

    python tests/seg_f64_distance.py [card_test|phase38]

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


def card_test_setting():
    """(model config, the port's seeded model, batch) of
    `test_seg_train_step_on_the_card`."""
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
                        build_train_pipeline(data), 2, seed=0).make_batch(0)
    model = model_cfg.build(generator=torch.Generator().manual_seed(0))
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
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState, make_seg_train_step

    out = {}
    keys = ("img", "depth_gt", "cam_height")
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        m = copy.deepcopy(model).to(torch.float64 if name == "f64"
                                    else torch.float32)
        state = TrainState(m, toptim.make_optimizer(m),
                           toptim.lr_schedule(1e-6, 10, 0))
        metrics = make_seg_train_step(model_cfg.depth_scale)(
            state, {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                             dtype))
                    for k in keys})
        out[f"port_{name}"] = metrics["grad_norm"].item()
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
            _, jm = jax_step(jmodel, model_cfg.depth_scale, donate=False)(
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


def main(argv):
    import os

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
