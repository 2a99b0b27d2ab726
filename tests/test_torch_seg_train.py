"""Training the seg preset (`ocrnet_hr18_kitti`) in the port against the
JAX package, on the CPU: three steps of `make_seg_train_step` beside the
JAX step from the same weights (HRNet-W18, head_channels 8, batch 2 at
64x128, synthetic ground scenes whose PE channel gives both classes), and
`tools.train` as a CPU subprocess onto a seeded KITTI tree, whose
`best_miou.npz` the JAX `load_params_only` reads.

Tolerances. The three steps run in float64 on both sides, where f32's
rounding cannot hide a fault: each step's losses and grad_norm rtol 2e-6
(the step takes its losses on f32 casts of the logits, and the JAX step
sums the gradient norm in f32: ~3e-7 relative each), every parameter and
BatchNorm statistic after the third rtol 1e-6, atol 1e-6 of the tensor's
largest value, and more than half of the parameters moved by more than
lr/2 at lr 1e-6. The port's f32 step from the same weights against the
float64 step's metrics: losses rtol 1e-4, grad_norm rtol 2e-3. That norm
is ill-conditioned in f32: the stem's and stage 1's weight gradients, which
dominate it, sum ~1e4 positions of a train-mode BatchNorm's centred
gradient times a non-negative input, so f32 keeps them to ~3% (2.7% for
backbone.conv2.weight) and the norm to ~1e-3 (8.5e-4 for the port, 2.3e-3
for the JAX package's f32 step at these weights).
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_seg import H, PRESET, W, bridged, kitti_tree  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _batches(steps, batch=2):
    """Synthetic ground scenes through the train chain: the PE channel
    agrees with the ground's depth, so both classes occur."""
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(H, W))
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=H, width=W),
                         build_train_pipeline(data), batch, seed=0)
    return [loader.make_batch(s) for s in range(steps)]


def test_seg_train_step_matches_jax():
    """Three steps of `make_seg_train_step` beside the JAX step, both in
    float64 from the same weights and batches: loss_seg0/1, loss and
    grad_norm each step, then every parameter and BatchNorm statistic.
    Then the port's f32 step from the same weights against the JAX
    float64 step's first metrics."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_seg_train_step as jax_step
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import (
        TrainState, ground_mask_labels, make_seg_train_step)

    lr, steps = 1e-6, 3
    batches = _batches(steps)
    labels = ground_mask_labels(torch.from_numpy(batches[0]["img"]),
                                torch.from_numpy(batches[0]["depth_gt"]),
                                200.0)
    assert 0.05 < labels.float().mean() < 0.95
    jmodel, variables, model = bridged(batches[0]["img"], seed=6)
    f64 = copy.deepcopy(model).double()
    before = {k: v.clone() for k, v in f64.state_dict().items()}
    step = make_seg_train_step(200.0)
    state64 = TrainState(f64, toptim.make_optimizer(f64),
                         toptim.lr_schedule(lr, 10, 0))

    def tensors(batch, dtype):
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype))
                for k in ("img", "depth_gt", "cam_height")}

    jax_metrics = []
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)),
                           variables)
        tx, _ = joptim.make_optimizer(lr, 10, 0)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               params=v64["params"],
                               batch_stats=v64["batch_stats"],
                               opt_state=tx.init(v64["params"]), tx=tx)
        jfn = jax_step(jmodel, 200.0, donate=False)
        for s, batch in enumerate(batches):
            jstate, jm = jfn(jstate, {k: jnp.asarray(np.asarray(
                v, np.float64)) for k, v in batch.items()},
                jax.random.PRNGKey(s))
            jm = {k: float(v) for k, v in jm.items()}
            jax_metrics.append(jm)
            tm = step(state64, tensors(batch, np.float64))
            assert set(tm) == {"loss_seg0", "loss_seg1", "loss",
                               "grad_norm", "lr"}
            for key in ("loss_seg0", "loss_seg1", "loss", "grad_norm"):
                np.testing.assert_allclose(tm[key].item(), jm[key],
                                           rtol=2e-6, err_msg=f"{key} {s}")
        params = jax.device_get(jstate.params)
        stats = jax.device_get(jstate.batch_stats)
    assert state64.step == steps

    want = state_dict_from_flax(params, stats)
    got = f64.state_dict()
    assert set(want) == set(got)
    moved = total = 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        g, w = got[key].numpy(), value.double().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=key)
        if not key.endswith(("running_mean", "running_var")):
            moved += int((np.abs(w - before[key].numpy()) > lr / 2).sum())
            total += w.size
    assert moved > 0.5 * total

    # the f32 step (the one training runs) from the same weights
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(lr, 10, 0))
    tm = step(state, tensors(batches[0], np.float32))
    for key in ("loss_seg0", "loss_seg1", "loss", "grad_norm"):
        np.testing.assert_allclose(tm[key].item(), jax_metrics[0][key],
                                   rtol=2e-3 if key == "grad_norm" else 1e-4,
                                   err_msg=f"f32 {key}")


def test_tools_train_on_a_kitti_tree(kitti_tree, tmp_path):
    """`python -m gedepth_tpu_torch.tools.train ocrnet_hr18_kitti --device
    cpu` for 2 steps over --options onto the tree: `train` records with
    loss_seg0/1, a `val` record with miou, acc and iou_cls0/1, the best
    JSON line, and `best_miou.npz`, which the JAX `load_params_only` reads
    into the JAX model's tree as the port reads it."""
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.train.checkpoint import load_params_only as jax_load
    from gedepth_tpu_torch.convert.from_jax import (
        flax_variables_from_state_dict)
    from gedepth_tpu_torch.train.checkpoint import load_params_only

    from test_torch_gedepth import _random_variables

    root, splits = kitti_tree
    work = tmp_path / "work"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    proc = subprocess.run(
        [sys.executable, "-m", "gedepth_tpu_torch.tools.train", PRESET,
         "--device", "cpu", "--max-iters", "2", "--eval-max-images", "2",
         "--work-dir", str(work), "--options", f"data.data_root={root}",
         f"data.train_split={splits['train']}",
         f"data.test_split={splits['test']}", "data.eval_size=(96,320)",
         "data.crop_size=(64,128)", "model.head_channels=8",
         "train.global_batch=2", "train.num_workers=0",
         "train.log_interval=1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    best = json.loads(proc.stdout.strip().splitlines()[-1])
    assert best["iter"] == 2 and best["images"] == 2
    assert sorted(os.listdir(work)) == ["best_miou.npz", "ckpts", "tb",
                                        "train.log.jsonl"]
    records = [json.loads(line) for line in
               (work / "train.log.jsonl").read_text().splitlines()]
    train = [r for r in records if r["mode"] == "train"]
    vals = [r for r in records if r["mode"] == "val"]
    assert [r["iter"] for r in train] == [1, 2]
    for r in train:
        assert np.isfinite([r["loss"], r["loss_seg0"], r["loss_seg1"],
                            r["grad_norm"]]).all()
        np.testing.assert_allclose(r["loss"], r["loss_seg0"]
                                   + r["loss_seg1"], rtol=1e-6)
    assert len(vals) == 1 and {"miou", "acc", "iou_cls0", "iou_cls1"} <= set(
        vals[0])
    assert best["miou"] == vals[0]["miou"]
    assert 0 <= vals[0]["miou"] <= 1 and 0 <= vals[0]["acc"] <= 1

    npz = str(work / "best_miou.npz")
    cfg = dataclasses.replace(get_config(PRESET).model, head_channels=8)
    port = load_params_only(npz, cfg.build())
    jcfg = dataclasses.replace(jax_get_config(PRESET).model, head_channels=8)
    template = _random_variables(jcfg.build().init,
                                 jnp.zeros((1, H, W, 5)), None)
    params, stats = jax_load(npz, template["params"],
                             template["batch_stats"])
    want = state_dict_from_flax(jax.device_get(params),
                                jax.device_get(stats))
    got = port.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    ref_p, _ = flax_variables_from_state_dict(got)
    assert set(ref_p) == {"backbone", "aux_head", "ocr_head"}


def test_tools_test_refuses_the_seg_preset(capsys):
    """`tools.test` evaluates depth; the seg preset, which predicts none,
    is refused with a pointer to the train loop's `SegEvaluator` (the JAX
    tools/test.py builds the depth `Evaluator` only)."""
    import pytest

    from gedepth_tpu_torch.tools import test as test_cli

    with pytest.raises(SystemExit):
        test_cli.main([PRESET, "--device", "cpu"])
    assert "SegEvaluator" in capsys.readouterr().err
