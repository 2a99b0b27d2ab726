"""Two processes of the port (gloo on the CPU) against one process and
against the JAX package.

The JAX package trains one GSPMD program whose loss, BatchNorm statistics
and random masks are those of the global batch whatever the device count
(tests/test_multihost.py). The port runs one process per card and keeps
that contract through `gedepth_tpu_torch.parallel`. Here two ranks at batch
1 each run the train step, the sharded `Evaluator` and `train()` on the
smoke widths (64x128, the exact neck, BatchNorm in the stem and the neck),
and one process does the same at batch 2:

  * the train step, DropPath at 0.1 and dropout on: loss and grad_norm
    rtol 1e-5, every gradient within 1e-4 of its largest magnitude, the
    BatchNorm running statistics rtol 1e-5; with DropPath and dropout off
    and seeded JAX variables carried over, the loss also equals the JAX
    `make_train_step` loss (rtol 1e-4);
  * the Evaluator over 3 images (shards of 2 and 1): aggregates equal to
    the one-process ones and to the JAX `Evaluator`'s (rtol 1e-5);
  * `train()` for 2 steps with evaluation and checkpoints into one work
    dir, then a resume of both ranks from that checkpoint for a third:
    every rank's loss, grad_norm and `best` equal the one-process run's,
    and only rank 0 wrote (each log record once).

The ranks are this file run as a script in two subprocesses with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), each with its own
timeout; they and the one-process references run on one torch thread.
"""
import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gedepth_tpu_torch import parallel  # noqa: E402
from gedepth_tpu_torch.configs import get_config  # noqa: E402

H, W = 64, 128
EVAL_IMAGES = 3
WORKER_TIMEOUT = 300          # seconds, each rank

torch.set_num_threads(1)


def smoke_cfg(**model_over):
    cfg = get_config("smoke_synthetic")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_over),
        data=dataclasses.replace(cfg.data, crop_size=(H, W), eval_size=(H, W),
                                 synthetic_size=4),
        train=dataclasses.replace(cfg.train, global_batch=2, eval_interval=2,
                                  checkpoint_interval=2, log_interval=1,
                                  max_keep_ckpts=1))


def _model(cfg, weights=None, dropout=True):
    from gedepth_tpu_torch.models.layers import Dropout

    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(torch.load(weights, weights_only=True),
                              strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return model


def step_result(weights=None, drop_path_rate=0.1, dropout=True):
    """One `make_train_step` on this process's rows of global batch 0 (the
    whole batch without a process group)."""
    from gedepth_tpu_torch.data import (
        SyntheticGroundDataset, TrainLoader, build_train_pipeline)
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state, make_train_step)

    cfg = smoke_cfg(drop_path_rate=drop_path_rate)
    model = _model(cfg, weights, dropout)
    state = create_train_state(model, cfg.optim, 10, seed=1)
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=H, width=W),
                         build_train_pipeline(cfg.data), 2, seed=0,
                         shard_index=parallel.rank(),
                         shard_count=parallel.world())
    metrics = make_train_step()(state, batch_to_device(loader.make_batch(0),
                                                       "cpu"))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def eval_result(weights):
    """The Evaluator over EVAL_IMAGES synthetic frames, sharded by the
    process group when there is one."""
    from gedepth_tpu_torch.data import SyntheticGroundDataset
    from gedepth_tpu_torch.eval import Evaluator

    cfg = smoke_cfg()
    model = _model(cfg, weights)
    agg, rows = Evaluator(model, SyntheticGroundDataset(
        size=EVAL_IMAGES, height=H, width=W, seed=1), cfg.data).run()
    return {"agg": agg, "rows": rows}


def train_result(work_dir):
    """`train()` for 2 steps into `work_dir`, then resumed from its
    checkpoint for a third."""
    from gedepth_tpu_torch.train.loop import train

    cfg = smoke_cfg()
    _, first, best = train(cfg, work_dir=work_dir, max_iters=2,
                           device="cpu")
    state, second, best3 = train(
        cfg, work_dir=work_dir, max_iters=3, device="cpu",
        resume_from=os.path.join(work_dir, "ckpts"))
    keep = ("iter", "loss", "grad_norm", "abs_rel", "rmse", "a1", "images")
    return {"history": [{k: r[k] for k in keep if k in r}
                        for r in first + second],
            "best": {k: v for k, v in best.items() if k != "time"},
            "best3": {k: v for k, v in best3.items() if k != "time"},
            "step": state.step}


def _worker(spec_path):
    spec = json.loads(Path(spec_path).read_text())
    parallel.init_from_env("cpu")
    try:
        out = {"world": parallel.world(), "rank": parallel.rank(),
               "steps": [step_result(**s) for s in spec["steps"]],
               "eval": eval_result(spec["weights"]),
               "train": train_result(spec["work_dir"])}
        torch.save(out, spec["out"].format(rank=parallel.rank()))
    finally:
        parallel.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(spec, tmp, world=2):
    """This file as a script in `world` processes with torchrun's
    environment."""
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return [subprocess.Popen(
        [sys.executable, __file__, str(path)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, started first, then the one-process references and
    the JAX package's numbers while they run."""
    import jax
    import jax.numpy as jnp

    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu_torch.convert import state_dict_from_flax

    from test_torch_gedepth import _random_variables

    tmp = tmp_path_factory.mktemp("ranks")
    jmodel = dataclasses.replace(jax_get_config("smoke_synthetic").model,
                                 drop_path_rate=0.0).build()
    variables = jax.device_get(_random_variables(
        jmodel.init, jnp.zeros((1, H, W, 5)), jnp.ones((1,)), seed=5))
    weights = str(tmp / "weights.pt")
    torch.save(state_dict_from_flax(variables["params"],
                                    variables["batch_stats"]), weights)
    steps = [dict(), dict(weights=weights, drop_path_rate=0.0,
                          dropout=False)]
    procs = _start_ranks({"steps": steps, "weights": weights,
                          "work_dir": str(tmp / "work"),
                          "out": str(tmp / "rank{rank}.pt")}, tmp)
    try:
        one = {"steps": [step_result(**s) for s in steps],
               "eval": eval_result(weights),
               "train": train_result(str(tmp / "one"))}
        jax_ref = _jax_numbers(jmodel, variables)
    finally:
        logs = _wait(procs)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return {"one": one, "ranks": ranks, "jax": jax_ref, "logs": logs,
            "work": tmp / "work"}


def _jax_numbers(jmodel, variables):
    """The JAX train step's loss on batch 0 (dropout as the identity) and
    the JAX Evaluator's aggregates, on the same variables."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS
    from gedepth_tpu.eval.evaluator import Evaluator as JaxEvaluator
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step
    from gedepth_tpu_torch.data import (
        SyntheticGroundDataset, TrainLoader, build_train_pipeline)

    cfg = smoke_cfg()
    batch = TrainLoader(SyntheticGroundDataset(size=4, height=H, width=W),
                        build_train_pipeline(cfg.data), 2,
                        seed=0).make_batch(0)
    tx, _ = joptim.make_optimizer(1e-6, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)

    class _Identity:
        def __init__(self, *args, **kwargs):
            pass

        def __call__(self, x, *args, **kwargs):
            return x

    saved = flax.linen.Dropout
    flax.linen.Dropout = _Identity
    try:
        _, jm = jax_train_step(jmodel, donate=False)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
    finally:
        flax.linen.Dropout = saved
    agg, _ = JaxEvaluator(jmodel, JaxDS(size=EVAL_IMAGES, height=H, width=W,
                                        seed=1),
                          jax_get_config("smoke_synthetic").data,
                          process_index=0, process_count=1).run(
        variables["params"], variables["batch_stats"])
    return {"loss": float(jm["loss"]), "agg": {k: float(v)
                                               for k, v in agg.items()}}


def _assert_grads_close(got, want):
    """Each gradient within 1e-4 of its largest magnitude. The gradients
    that are zero in exact arithmetic (the `backbone.norm{i}.bias`: a
    LayerNorm bias that feeds only a 1x1 conv into a train-mode BatchNorm,
    which takes the shift out again) hold rounding noise ~1e-9 of the
    model's largest gradient on both sides; those are held below 1e-6 of it
    instead, on both sides."""
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    zero = 0
    for name, g in got.items():
        ref = want[name]
        scale = float(ref.abs().max())
        if scale < 1e-6 * top:
            zero += 1
            assert float(g.abs().max()) < 1e-6 * top, name
            continue
        diff = float((g - ref).abs().max())
        assert diff <= 1e-4 * scale, (name, diff, scale)
    assert zero <= 5            # the four norm biases and neck.level_embed


@pytest.mark.parametrize("case", ["droppath_dropout", "jax_weights"])
def test_two_ranks_step_equals_one_process(runs, case):
    i = ["droppath_dropout", "jax_weights"].index(case)
    want = runs["one"]["steps"][i]
    for rank in runs["ranks"]:
        assert rank["world"] == 2
        got = rank["steps"][i]
        for key in ("loss", "loss_depth", "loss_slope", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][key],
                                       want["metrics"][key], rtol=1e-5,
                                       err_msg=key)
        _assert_grads_close(got["grads"], want["grads"])
        assert set(got["stats"]) == set(want["stats"]) and got["stats"]
        for name, value in got["stats"].items():
            np.testing.assert_allclose(value.numpy(),
                                       want["stats"][name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
    # the two ranks hold the same (all-reduced) gradients
    a, b = (r["steps"][i]["grads"] for r in runs["ranks"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_two_rank_loss_equals_jax(runs):
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["steps"][1]["metrics"]["loss"],
                                   runs["jax"]["loss"], rtol=1e-4)


def test_sharded_evaluator(runs):
    want = runs["one"]["eval"]
    assert len(want["rows"]) == EVAL_IMAGES
    for rank in runs["ranks"]:
        got = rank["eval"]
        # process order: rank 0's images 0 and 2, then rank 1's image 1
        np.testing.assert_allclose(
            np.asarray(got["rows"]),
            np.asarray(want["rows"])[[0, 2, 1]], rtol=1e-6)
        assert list(got["agg"]) == list(want["agg"])
        for key, value in got["agg"].items():
            np.testing.assert_allclose(value, want["agg"][key], rtol=1e-5,
                                       err_msg=key)
            np.testing.assert_allclose(value, runs["jax"]["agg"][key],
                                       rtol=1e-5, err_msg=key)


def test_two_rank_train_loop(runs):
    want = runs["one"]["train"]
    for rank in runs["ranks"]:
        got = rank["train"]
        assert got["step"] == 3
        assert [r["iter"] for r in got["history"]] == [
            r["iter"] for r in want["history"]] == [1, 2, 2, 3, 3]
        for g, w in zip(got["history"], want["history"]):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=f"{key} at {g['iter']}")
        for best in ("best", "best3"):
            assert got[best].keys() == want[best].keys()
            assert got[best]["mode"] == "val"
            for key, value in got[best].items():
                if key != "mode":
                    np.testing.assert_allclose(value, want[best][key],
                                               rtol=1e-5, err_msg=key)
    a, b = (r["train"]["best3"] for r in runs["ranks"])
    assert a == b


def test_only_rank_zero_writes(runs):
    work = runs["work"]
    log = [json.loads(line) for line in
           (work / "train.log.jsonl").read_text().splitlines()]
    # a second writer would repeat every record
    assert [(r["mode"], r.get("iter")) for r in log] == [
        ("env", None), ("train", 1), ("train", 2), ("val", 2),
        ("env", None), ("train", 3), ("val", 3)]
    assert sorted(os.listdir(work / "ckpts")) == ["ckpt_00000003.pt"]
    assert (work / "best_abs_rel.npz").exists()
    # TensorBoard's events where the package imports: one file a train()
    # call, process 0's
    tb = importlib.util.find_spec("tensorboard") is not None
    assert sorted(os.listdir(work)) == ["best_abs_rel.npz", "ckpts"] + (
        ["tb"] if tb else []) + ["train.log.jsonl"]
    if tb:
        assert len(os.listdir(work / "tb")) == 2
    # process 0 alone prints
    assert "iter 1/2" in runs["logs"][0] and "iter 1/2" not in runs["logs"][1]


def test_global_batch_must_divide(monkeypatch):
    monkeypatch.setattr(parallel.dist, "world", lambda: 3)
    with pytest.raises(ValueError, match="world size 3"):
        parallel.local_rows(4)
    assert parallel.local_rows(6) == 2


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(sys.argv[1])
