"""The port's checkpoints, resume, evaluation inside the train loop and the
JAX package's params-only `.npz`, against `gedepth_tpu.train.checkpoint`
and the JAX loop's rules, on the CPU.

The `.npz` goes both ways: written by the JAX package (scanned Swin layout)
and loaded by the port, and written by the port (per-block layout) and
loaded by `gedepth_tpu.train.checkpoint.load_params_only` into models of
both `swin_scan` layouts. The weights must arrive bit for bit and both
packages must give the same depth, f32, rtol 1e-4 and atol 1e-3 m (the
tolerance of tests/test_torch_gedepth.py). A checkpoint restores bit for
bit. Resume follows the JAX loop: model, AdamW moments, step and the
BatchNorm statistics continue, while the loader's stream and the dropout
generator start again; two resumes from one checkpoint are bit-equal.
The loop tests train a model of tiny widths on 64x128 synthetic frames.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.train import checkpoint as jckpt
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.convert.from_jax import _flatten, unstack_swin_params
from gedepth_tpu_torch.train import checkpoint as tckpt
from gedepth_tpu_torch.train.loop import (
    GREATER_IS_BETTER, LESS_IS_BETTER, best_rule, build_train_dataset, train)
from gedepth_tpu_torch.train.optim import lr_schedule
from gedepth_tpu_torch.train.steps import (
    batch_to_device, create_train_state, make_train_step)
from gedepth_tpu_torch.data.loader import TrainLoader
from gedepth_tpu_torch.data.transforms import build_train_pipeline

from test_torch_gedepth import H, W, _configs, _random_variables, _sample

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dims=16, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 8),
            window=2, neck_channels=(64, 16, 32, 64, 128), neck_embed_dim=32,
            neck_num_points=4, head_channels=16)


def tiny_cfg(**train_over):
    """smoke_synthetic at tiny widths on 64x128 frames, 2 test images,
    evaluation without flip-TTA."""
    cfg = get_config("smoke_synthetic")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **TINY),
        data=dataclasses.replace(cfg.data, crop_size=(64, 128),
                                 eval_size=(64, 128), synthetic_size=8,
                                 eval_flip_tta=False),
        train=dataclasses.replace(cfg.train, **train_over))


def _jax_depth(jmodel, variables, img, cam):
    return np.asarray(jax.jit(functools.partial(
        jmodel.apply, method=jmodel.predict_depth))(
            variables, jnp.asarray(img), jnp.asarray(cam)))


def _port_depth(model, img, cam):
    with torch.inference_mode():
        return model.predict_depth(torch.from_numpy(img),
                                   torch.from_numpy(cam)).numpy()


def _assert_same_leaves(got, want):
    got, want = dict(_flatten(got)), dict(_flatten(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ---- the params-only .npz, both ways ---------------------------------

def test_npz_written_by_jax_loads_into_the_port(tmp_path):
    """JAX writes from a scanned-Swin model; the port reads it (unstacking
    the pairs): every tensor equal to the JAX leaf, the same depth."""
    jmodel_cfg, tmodel_cfg = _configs(True)
    jmodel = jmodel_cfg.build()
    img = _sample(np.random.default_rng(0), H, W)
    cam = np.asarray([1.6], np.float32)
    variables = _random_variables(jmodel.init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=5)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"], variables["batch_stats"])

    model = tckpt.load_params_only(path, tmodel_cfg.build())
    want = state_dict_from_flax(variables["params"], variables["batch_stats"])
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_allclose(_port_depth(model, img, cam),
                               _jax_depth(jmodel, variables, img, cam),
                               rtol=1e-4, atol=1e-3)


def test_npz_written_by_the_port_loads_into_jax(tmp_path):
    """The port writes (per-block layout); `gedepth_tpu.train.checkpoint.
    load_params_only` reads it into models of both `swin_scan` layouts with
    no missing key and every leaf equal; the same depth."""
    img = _sample(np.random.default_rng(1), H, W)
    cam = np.asarray([1.7], np.float32)
    jmodel_cfg, tmodel_cfg = _configs(False)
    source = _random_variables(jmodel_cfg.build().init, jnp.asarray(img),
                               jnp.asarray(cam), seed=6)
    model = tmodel_cfg.build()
    model.load_state_dict(state_dict_from_flax(source["params"],
                                               source["batch_stats"]))
    path = str(tmp_path / "port.npz")
    tckpt.save_params_only(path, model)
    keys = set(np.load(path).files)
    assert {k.split("/")[0] for k in keys} == {"params", "batch_stats"}
    assert not any("num_batches_tracked" in k for k in keys)

    for scan in (False, True):
        jcfg, _ = _configs(scan)
        jmodel = jcfg.build()
        template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                  jnp.asarray(img), jnp.asarray(cam))
        params, stats = jckpt.load_params_only(
            path, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                               template["params"]),
            jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         template["batch_stats"]))
        params = jax.tree.map(np.asarray, params)
        stats = jax.tree.map(np.asarray, stats)
        if scan:
            params = dict(params, backbone=unstack_swin_params(
                params["backbone"]))
        _assert_same_leaves(params, source["params"])
        _assert_same_leaves(stats, source["batch_stats"])
    np.testing.assert_allclose(_port_depth(model, img, cam),
                               _jax_depth(jmodel_cfg.build(), source, img,
                                          cam),
                               rtol=1e-4, atol=1e-3)


def test_load_params_only_refuses_another_tree(tmp_path):
    """A windowed tree (no neck.reference_points) does not load into the
    exact model: the error names the sampling mode."""
    _, tmodel_cfg = _configs(False)
    path = str(tmp_path / "windowed.npz")
    tckpt.save_params_only(path, tmodel_cfg.build())
    exact = dataclasses.replace(tmodel_cfg, neck_sampling="bilinear").build()
    with pytest.raises(ValueError, match="sampling mode"):
        tckpt.load_params_only(path, exact)


# ---- checkpoints -----------------------------------------------------

def _state_after_one_step(cfg, seed=0):
    model = cfg.model.build(generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, cfg.optim, 10, seed=seed + 1)
    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data, cfg.model.depth_scale),
                         cfg.train.global_batch, seed=seed)
    batch = batch_to_device(next(iter(loader)), torch.device("cpu"))
    make_train_step()(state, batch)
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k].cpu(), sb[k].cpu()), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        for name, t in oa["state"][i].items():
            assert torch.equal(t.cpu(), ob["state"][i][name].cpu()), (i, name)


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Parameters, BatchNorm statistics, AdamW's moments and step, restored
    into a freshly built state of another seed."""
    cfg = tiny_cfg()
    state = _state_after_one_step(cfg)
    path = tckpt.save_checkpoint(str(tmp_path), state, state.step)
    assert os.path.basename(path) == "ckpt_00000001.pt"
    assert os.listdir(tmp_path) == ["ckpt_00000001.pt"]   # no .tmp left
    fresh = create_train_state(
        cfg.model.build(generator=torch.Generator().manual_seed(9)),
        cfg.optim, 10)
    assert fresh.step == 0
    restored = tckpt.restore_checkpoint(str(tmp_path), fresh)
    assert restored is fresh
    _assert_states_equal(restored, state)


def test_keeper_keeps_the_newest_and_restores_the_latest(tmp_path):
    cfg = tiny_cfg()
    state = create_train_state(cfg.model.build(), cfg.optim, 10)
    keeper = tckpt.CheckpointKeeper(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 10):
        state.step = step
        keeper.save(state, step)
    assert tckpt.checkpoint_steps(str(tmp_path)) == [3, 10]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.pt",
                                            "ckpt_00000010.pt"]
    assert tckpt.restore_checkpoint(str(tmp_path), state).step == 10
    assert tckpt.restore_checkpoint(str(tmp_path), state, step=3).step == 3
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), state, step=1)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), state)


# ---- the loop: evaluation, best weights, resume -----------------------

def test_val_records_at_eval_interval_and_last(tmp_path):
    """max_iters 3, eval_interval 2: evaluations after steps 2 and 3, 'val'
    records in the history and the log after an 'env' record, the best
    weights as an .npz of the best record's step, checkpoints at 2 and 3;
    the model is back in train mode and trains on after an evaluation."""
    cfg = tiny_cfg(eval_interval=2, checkpoint_interval=2, max_keep_ckpts=2,
                   log_interval=1)
    work = tmp_path / "run"
    state, history, best = train(cfg, work_dir=str(work), max_iters=3,
                                 eval_max_images=1, device="cpu")
    assert [(r["mode"], r["iter"]) for r in history] == [
        ("train", 1), ("train", 2), ("val", 2), ("train", 3), ("val", 3)]
    vals = [r for r in history if r["mode"] == "val"]
    metrics = LESS_IS_BETTER + GREATER_IS_BETTER
    for r in vals:
        assert r["images"] == 1
        assert all(np.isfinite(r[k]) for k in metrics)
    assert best == min(vals, key=lambda r: r["abs_rel"])
    log = [json.loads(line) for line in
           (work / "train.log.jsonl").read_text().splitlines()]
    assert log[0]["mode"] == "env" and "torch" in log[0]
    assert [r for r in log[1:] if r["mode"] == "val"] == vals
    assert sorted(os.listdir(work / "ckpts")) == ["ckpt_00000002.pt",
                                                  "ckpt_00000003.pt"]
    best_model = tckpt.load_params_only(str(work / "best_abs_rel.npz"),
                                        cfg.model.build())
    at = cfg.model.build()
    tckpt.restore_checkpoint(str(work / "ckpts"), create_train_state(
        at, cfg.optim, 3), step=best["iter"])
    for k, v in at.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(best_model.state_dict()[k], v), k
    assert state.model.training and state.step == 3


def test_no_work_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, history, best = train(tiny_cfg(), max_iters=1, eval_max_images=1,
                             device="cpu")
    assert [r["mode"] for r in history] == ["train", "val"]
    assert best["iter"] == 1
    assert os.listdir(tmp_path) == []


def _untimed(history):
    return [{k: v for k, v in r.items() if k != "time"} for r in history]


def _manual_first_step(cfg, ckpt_dir, max_iters):
    """What the JAX loop does on resume: the restored state, a fresh loader
    (its first batch) and a fresh generator (seed + 1), one step."""
    seed = cfg.train.seed
    model = cfg.model.build(generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, cfg.optim, max_iters, seed=seed + 1)
    tckpt.restore_checkpoint(ckpt_dir, state)
    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data, cfg.model.depth_scale),
                         cfg.train.global_batch, seed=seed)
    make_train_step()(state, batch_to_device(next(iter(loader)),
                                             torch.device("cpu")))
    return state


def test_resume_follows_the_jax_loop(tmp_path):
    """Two steps with a checkpoint, then two resumes to step 4 from it:
    bit-equal to each other; step, LR schedule and BatchNorm statistics
    continue from the checkpoint; the first resumed step is the restored
    state trained on the loader's first batch (the stream starts again)."""
    cfg = tiny_cfg(checkpoint_interval=2, eval_interval=100)
    work = str(tmp_path / "run")
    first, _, _ = train(cfg, work_dir=work, max_iters=2, eval_max_images=1,
                        device="cpu")
    ckpts = os.path.join(work, "ckpts")
    assert tckpt.checkpoint_steps(ckpts) == [2]

    runs = [train(cfg, max_iters=4, eval_max_images=1, resume_from=ckpts,
                  device="cpu") for _ in range(2)]
    (a, hist_a, _), (b, hist_b, _) = runs
    assert _untimed(hist_a) == _untimed(hist_b)
    _assert_states_equal(a, b)
    steps = [r for r in hist_a if r["mode"] == "train"]
    assert [r["iter"] for r in steps] == [3, 4] and a.step == 4
    schedule = lr_schedule(cfg.optim.max_lr, 4, cfg.optim.warmup_iters,
                           cfg.optim.warmup_ratio, cfg.optim.min_lr_ratio)
    assert [r["lr"] for r in steps] == [schedule(2), schedule(3)]
    tracked = dict(a.model.named_buffers())["backbone.bn1.num_batches_tracked"]
    assert tracked.item() == 4
    assert dict(first.model.named_buffers())[
        "backbone.bn1.num_batches_tracked"].item() == 2

    manual = _manual_first_step(cfg, ckpts, 3)
    once, _, _ = train(cfg, max_iters=3, eval_max_images=1,
                       resume_from=ckpts, device="cpu")
    for k, v in manual.model.state_dict().items():
        assert torch.equal(once.model.state_dict()[k], v), k


def test_resume_state_continues_a_returned_state():
    """resume_state: the state train() returned runs on from its step."""
    cfg = tiny_cfg(eval_interval=100)
    state, _, _ = train(cfg, max_iters=1, eval_max_images=1, device="cpu")
    again, history, _ = train(cfg, max_iters=2, eval_max_images=1,
                              resume_state=state, device="cpu")
    assert again is state and state.step == 2
    assert [(r["mode"], r["iter"]) for r in history] == [("train", 2),
                                                          ("val", 2)]


@pytest.mark.parametrize("save_best,key,sign", [
    *[(m, m, 1.0) for m in LESS_IS_BETTER],
    *[(m, m, -1.0) for m in GREATER_IS_BETTER],
    ("miou", "abs_rel", 1.0), ("", "abs_rel", 1.0)])
def test_best_rule(save_best, key, sign):
    """less for the six error metrics, greater for a1-a3, and the
    evaluator's key metric for a name it does not publish, as the JAX loop
    (gedepth_tpu/train/loop.py:269-276)."""
    assert best_rule(save_best) == (key, sign)


def test_greater_rule_keeps_the_largest(tmp_path):
    cfg = tiny_cfg(eval_interval=1, save_best="a3")
    _, history, best = train(cfg, work_dir=str(tmp_path), max_iters=2,
                             eval_max_images=1, device="cpu")
    vals = [r for r in history if r["mode"] == "val"]
    assert len(vals) == 2
    assert best["a3"] == max(r["a3"] for r in vals)
    assert best["iter"] == max(vals, key=lambda r: r["a3"])["iter"]
    assert (tmp_path / "best_a3.npz").exists()


# ---- the command-line tools ------------------------------------------

def _run(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


RUN = ("gedepth_tpu_torch.tools.train", "smoke_synthetic", "--device", "cpu",
       "--eval-max-images", "1")


def test_tools_train_writes_its_work_dir(tmp_path):
    """`tools.train` with its default work dir (work_dirs/<preset> under
    the current directory) and `--eval-max-images 1`."""
    best = json.loads(_run(*RUN, "--max-iters", "1",
                           cwd=tmp_path).splitlines()[-1])
    work = tmp_path / "work_dirs" / "smoke_synthetic"
    assert best["iter"] == 1 and best["images"] == 1
    assert best["work_dir"] == os.path.join("work_dirs", "smoke_synthetic")
    assert (work / "best_abs_rel.npz").exists()
    assert tckpt.checkpoint_steps(str(work / "ckpts")) == [1]
    log = [json.loads(line) for line in
           (work / "train.log.jsonl").read_text().splitlines()]
    assert [(r["mode"], r.get("iter")) for r in log] == [
        ("env", None), ("train", 1), ("val", 1)]


def test_tools_train_resumes_on_the_cpu(tmp_path):
    """`tools.train --resume-from` a checkpoint of step 1 runs step 2 only,
    then evaluates and saves it."""
    cfg = get_config("smoke_synthetic")
    state = create_train_state(cfg.model.build(), cfg.optim, 2)
    state.step = 1
    ckpts = str(tmp_path / "ckpts")
    tckpt.save_checkpoint(ckpts, state, 1)
    work = tmp_path / "resumed"
    out = _run(*RUN, "--max-iters", "2", "--resume-from", ckpts,
               "--work-dir", str(work), cwd=tmp_path)
    assert "resumed from" in out and "at iter 1" in out
    assert json.loads(out.splitlines()[-1])["iter"] == 2
    assert tckpt.checkpoint_steps(str(work / "ckpts")) == [2]
    log = [json.loads(line) for line in
           (work / "train.log.jsonl").read_text().splitlines()]
    assert [(r["mode"], r.get("iter")) for r in log] == [
        ("env", None), ("train", 2), ("val", 2)]


def test_tools_test_reads_an_npz(tmp_path):
    """`tools.test <preset> <ckpt.npz>`: the weights of the file, not the
    seeded ones (another seed's weights give other metrics)."""
    cfg = get_config("smoke_synthetic")
    npz = str(tmp_path / "w.npz")
    tckpt.save_params_only(npz, cfg.model.build(
        generator=torch.Generator().manual_seed(7)))
    cmd = ("gedepth_tpu_torch.tools.test", "smoke_synthetic", "--device",
           "cpu", "--max-images", "1", "--no-tta")
    loaded = json.loads(_run(*cmd[:2], npz, *cmd[2:],
                             cwd=tmp_path).splitlines()[-1])
    seeded = json.loads(_run(*cmd, cwd=tmp_path).splitlines()[-1])
    assert loaded["images"] == seeded["images"] == 1
    assert np.isfinite(loaded["abs_rel"])
    assert loaded["abs_rel"] != seeded["abs_rel"]


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("tool", ["train", "test", "convert_torch_checkpoint",
                                  "compat_check"])
def test_tools_switch_tf32_off(monkeypatch, tmp_path, tool):
    """Each command-line tool runs its work with TF32 off for matmuls and
    convolutions, whatever the process had set; its work is stubbed here
    and reads the flags when it is called."""
    import importlib

    import gedepth_tpu_torch.convert.from_pth as from_pth
    import gedepth_tpu_torch.eval as eval_pkg
    import gedepth_tpu_torch.train.loop as loop

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert _flags() == (True, True)
    seen = []

    def record(result):
        def stub(*args, **kwargs):
            seen.append(_flags())
            return result
        return stub

    cli = importlib.import_module(f"gedepth_tpu_torch.tools.{tool}")
    argv = ["smoke_synthetic", "--device", "cpu"]
    if tool == "train":
        monkeypatch.setattr(loop, "train", record((None, [], {"a1": 0.0})))
    elif tool == "test":
        class Evaluator:
            def __init__(self, *args, **kwargs):
                seen.append(_flags())

            def run(self, **kwargs):
                return {}, []
        monkeypatch.setattr(eval_pkg, "Evaluator", Evaluator)
    elif tool == "convert_torch_checkpoint":
        monkeypatch.setattr(from_pth, "convert_checkpoint_file", record(
            (None, {"unmapped_torch_keys": [], "missing_params": [],
                    "missing_stats": []})))
        monkeypatch.setattr(tckpt, "save_params_only", lambda *a: None)
        argv = ["in.pth", "smoke_synthetic", str(tmp_path / "out.npz")]
    else:
        row = {"radius": 4, "delta_f32": 2e-3, "delta_scope": 1e-3,
               "clamp_mass": {"self_attn": 0.1, "multi_att": 0.2},
               "clears_f32": False, "clears_scope": True}
        monkeypatch.setattr(cli, "compat_check", record([row]))
        argv = ["w.npz", "--device", "cpu"]
    cli.main(argv)
    assert seen == [(False, False)]
