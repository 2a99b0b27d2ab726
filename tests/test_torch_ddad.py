"""Training, evaluation and serving from KITTI and DDAD trees, the port
against the JAX package, on the CPU, at smoke widths.

Trees come from `tools.make_tree` (DDAD frames 152x242 resized to 64x128,
KITTI frames of two dates 120x400 and 115x382, KB-cropped to 96x320) and
are finished by the port's preprocessing tools. Each side reads the tree
with its own dataset and augments it with its own chain into its own
batches (equal to ~1e-6 after normalisation, tests/test_torch_transforms_
cv2.py), then runs three train steps as tests/test_torch_train.py runs
them: losses and gradient norm rtol 1e-4. The DDAD model carries DDAD's
constants (max_depth 200, depth_scale 250, camera heights per sample).
The Evaluators run on the same weights over the test split: per-image
metrics and aggregates rtol 1e-5 (DDAD's prediction is upsampled to the
GT with align_corners=True; KITTI's input is KB-cropped and flip-averaged).
`inference_depther` on a PNG path with `pe_path` against the JAX package's
on the same weights: rtol 1e-4, atol 1e-3 m (tests/test_torch_gedepth.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.train import optim as joptim
from gedepth_tpu_torch.configs import apply_options, get_config
from gedepth_tpu_torch.convert import load_flax_variables
from gedepth_tpu_torch.train import optim as toptim
from gedepth_tpu_torch.train.steps import TrainState, make_train_step

from test_torch_gedepth import _random_variables
from test_torch_train import _identity_dropout, _no_dropout, _tensors

torch.set_num_threads(1)

CROP = (64, 128)
DDAD_MODEL = dict(max_depth=200.0, depth_scale=250.0,
                  default_cam_height=1.55)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from gedepth_tpu_torch.tools import (
        preprocess_data_ddad, preprocess_data_kitti)
    from gedepth_tpu_torch.tools.make_tree import (
        make_ddad_tree, make_kitti_tree)

    kroot = str(tmp_path_factory.mktemp("kitti"))
    ks = make_kitti_tree(kroot, size=(120, 400), frames=3, seed=2)
    preprocess_data_kitti.main(["--data-root", kroot, "--split", ks["train"],
                                "--workers", "1"])
    droot = str(tmp_path_factory.mktemp("ddad"))
    ds = make_ddad_tree(droot, size=(152, 242), frames=3, seed=3)
    preprocess_data_ddad.main(["--data-root", droot, "--calib-npz",
                               ds["calib"], "--split", ds["train"],
                               "--workers", "1"])
    return {"kitti": (kroot, ks), "ddad": (droot, ds)}


def _cfgs(dataset, trees, **model_over):
    """(JAX config, port config): smoke widths with the windowed neck from
    level 1, the dataset's constants and data config on the tree."""
    root, splits = trees[dataset]
    data = dict(data_root=root, train_split=splits["train"],
                test_split=splits["test"], crop_size=CROP)
    if dataset == "ddad":
        data.update(ddad_resize=CROP, eval_size=CROP)
        model = dict(DDAD_MODEL, neck_sampling="windowed",
                     neck_hi_min_level=1)
        name = "gedepth_adaptive_ddad_tpu"
    else:
        data.update(eval_size=(96, 320))
        model = dict(neck_sampling="windowed", neck_hi_min_level=1)
        name = "gedepth_adaptive_kitti_tpu"
    model.update(model_over)
    out = []
    for get in (jax_get_config, get_config):
        smoke, cfg = get("smoke_synthetic"), get(name)
        out.append(cfg.replace(
            model=dataclasses.replace(
                smoke.model, **model,
                **({"swin_scan": False} if get is jax_get_config else {})),
            data=dataclasses.replace(cfg.data, **data),
            train=dataclasses.replace(cfg.train, global_batch=2)))
    return out


def _batches(dataset, trees, steps):
    """The batches of steps 0..steps-1 from both packages' loaders."""
    from gedepth_tpu.data.loader import TrainLoader as JaxLoader
    from gedepth_tpu.train.loop import build_datasets as jax_datasets
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import TrainLoader, build_train_pipeline
    from gedepth_tpu_torch.train.loop import build_train_dataset

    jcfg, tcfg = _cfgs(dataset, trees)
    jl = JaxLoader(jax_datasets(jcfg)[0], jax_chain(jcfg), 2, seed=5)
    tl = TrainLoader(build_train_dataset(tcfg),
                     build_train_pipeline(tcfg.data, tcfg.model.depth_scale),
                     2, seed=5)
    out = []
    for step in range(steps):
        got, want = tl.make_batch(step), jl._make_batch(step)
        assert sorted(got) == sorted(want)
        for key in ("depth_gt", "pe_k_gt", "cam_height", "index"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["img"][..., :4], want["img"][..., :4],
                                   rtol=0, atol=1e-4)
        out.append((got, want))
    return out


@pytest.mark.parametrize("dataset", ["ddad", "kitti"])
def test_train_steps_from_the_tree_match_jax(monkeypatch, trees, dataset):
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step

    _identity_dropout(monkeypatch)
    jcfg, tcfg = _cfgs(dataset, trees, drop_path_rate=0.0)
    lr, steps = 1e-6, 3
    batches = _batches(dataset, trees, steps)
    if dataset == "ddad":
        heights = {float(h) for got, _ in batches for h in got["cam_height"]}
        assert heights == {np.float32(1.56), np.float32(1.57)}
    jmodel = jcfg.model.build()
    first = batches[0][1]
    variables = _random_variables(jmodel.init, jnp.asarray(first["img"]),
                                  jnp.asarray(first["cam_height"]), seed=8)
    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_train_step(jmodel, donate=False)
    model = load_flax_variables(tcfg.model.build(), variables["params"],
                                variables["batch_stats"])
    _no_dropout(model)
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(lr, 10, 0),
                       torch.Generator().manual_seed(0))
    tstep = make_train_step()
    for i, (got, want) in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in want.items()},
                           jax.random.PRNGKey(i))
        tm = tstep(state, _tensors(got))
        for key in ("loss", "loss_depth", "loss_slope", "grad_norm"):
            assert np.isfinite(float(jm[key]))
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")


@pytest.fixture(scope="module")
def eval_models(trees):
    """{dataset: (JAX model, variables, port model)} on seeded weights."""
    out = {}
    for dataset in ("ddad", "kitti"):
        jcfg, tcfg = _cfgs(dataset, trees)
        jmodel = jcfg.model.build()
        h, w = jcfg.data.eval_size
        variables = _random_variables(jmodel.init, jnp.zeros((1, h, w, 5)),
                                      jnp.ones((1,)), seed=9)
        tmodel = load_flax_variables(tcfg.model.build(), variables["params"],
                                     variables["batch_stats"])
        out[dataset] = (jmodel, variables, tmodel)
    return out


@pytest.mark.parametrize("dataset", ["ddad", "kitti"])
def test_evaluator_on_the_tree_matches_jax(trees, eval_models, dataset):
    from gedepth_tpu.eval.evaluator import Evaluator as JaxEvaluator
    from gedepth_tpu.train.loop import build_datasets as jax_datasets
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    jcfg, tcfg = _cfgs(dataset, trees)
    jmodel, variables, tmodel = eval_models[dataset]
    jtest = jax_datasets(jcfg)[1]
    want_agg, want_rows = JaxEvaluator(
        jmodel, jtest, jcfg.data, batch_size=2, process_index=0,
        process_count=1).run(variables["params"], variables["batch_stats"])
    seen = []
    got_agg, got_rows = Evaluator(tmodel, build_eval_dataset(tcfg),
                                  tcfg.data, batch_size=2).run(
        on_prediction=lambda i, p: seen.append(p.shape))
    assert len(got_rows) == len(want_rows) == 2
    assert seen == [tcfg.data.eval_size] * 2
    np.testing.assert_allclose(np.asarray(got_rows, np.float64),
                               np.asarray(want_rows, np.float64), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(list(got_agg.values()),
                               list(want_agg.values()), rtol=1e-5)
    assert all(np.isfinite(v) for v in got_agg.values())


def test_inference_on_a_png_path_matches_jax(trees, eval_models, tmp_path):
    """The port's `init_depther(checkpoint=..., pe_path=...)` and
    `inference_depther` on a DDAD PNG path (resize to the eval size, no
    flip-TTA) against the JAX package's `inference_depther` on the same
    path, with the weights the `.npz` holds and the prior `pe_path` holds
    (as its `init_depther` reads it)."""
    import os.path as osp

    from gedepth_tpu.apis.inference import DeptherHandle
    from gedepth_tpu.apis.inference import inference_depther as jax_infer
    from gedepth_tpu.eval.evaluator import build_test_pipeline
    from gedepth_tpu.train.steps import make_eval_step
    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.train.checkpoint import save_params_only

    jcfg, tcfg = _cfgs("ddad", trees)
    jmodel, variables, tmodel = eval_models["ddad"]
    root, _ = trees["ddad"]
    npz = str(tmp_path / "weights.npz")
    save_params_only(npz, tmodel)
    pe_path = osp.join(root, "pe_public_debug", "CAMERA_05", "ddad_pe.npz")
    image = osp.join(root, "rgb", "CAMERA_05", "000001.png")
    jh = DeptherHandle(jcfg, jmodel, variables["params"],
                       variables["batch_stats"],
                       make_eval_step(jmodel, flip_tta=False),
                       build_test_pipeline(jcfg.data),
                       np.load(pe_path)["pe"].astype(np.float32))
    want = jax_infer(jh, image, cam_height=1.57)
    th = init_depther(tcfg, device="cpu", checkpoint=npz, pe_path=pe_path)
    got = inference_depther(th, image, cam_height=1.57)
    assert got.shape == want.shape == CROP
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="pe_path"):
        inference_depther(dataclasses.replace(th, pe_raw=None), image)
    with pytest.raises(ValueError, match="shape"):
        inference_depther(dataclasses.replace(th, pe_raw=th.pe_raw[:-1]),
                          image)
    with pytest.raises(ValueError, match="not both"):
        init_depther(tcfg, device="cpu", pe_path=pe_path, pe_raw=th.pe_raw)


OPTIONS = ["data.data_root=/data/kitti", "optim.max_lr=2e-4",
           "train.global_batch=8", "data.crop_size=(384,640)",
           "model.neck_sampling=windowed", "data.eval_flip_tta=False"]


def test_options_apply_as_tools_train():
    from tools.train import apply_options as jax_apply

    got = apply_options(get_config("gedepth_adaptive_kitti"), OPTIONS)
    want = jax_apply(jax_get_config("gedepth_adaptive_kitti"), OPTIONS)
    for part in ("model", "data", "optim", "train"):
        tpart, jpart = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(tpart):
            assert getattr(tpart, f.name) == getattr(jpart, f.name), f.name
    assert got.data.crop_size == (384, 640) and got.optim.max_lr == 2e-4
    assert got.data.data_root == "/data/kitti"


def test_tools_from_the_tree(trees, capsys, tmp_path):
    """`tools.train --list`; `tools.test` and `tools.train` pointed at the
    KITTI tree by --options, on the CPU; a missing root raises."""
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    train_cli.main(["--list"])
    listed = capsys.readouterr().out.split()
    assert {"gedepth_adaptive_ddad_tpu", "gedepth_vanilla_ddad",
            "gedepth_adaptive_ddad"} <= set(listed)
    root, splits = trees["kitti"]
    opts = ["--options", "data.dataset=kitti", f"data.data_root={root}",
            f"data.train_split={splits['train']}",
            f"data.test_split={splits['test']}", "data.eval_size=(96,320)",
            f"data.crop_size={CROP}", "data.eval_flip_tta=False"]
    test_cli.main(["smoke_synthetic", "--device", "cpu", "--max-images",
                   "1", *opts])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["images"] == 1 and np.isfinite(line["abs_rel"])
    train_cli.main(["smoke_synthetic", "--device", "cpu", "--max-iters", "1",
                    "--eval-max-images", "1", "--work-dir",
                    str(tmp_path / "work"), *opts])
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(best["abs_rel"]) and best["iter"] == 1
    with pytest.raises(FileNotFoundError, match="nowhere"):
        test_cli.main(["smoke_synthetic", "--device", "cpu", "--options",
                       "data.dataset=kitti",
                       f"data.data_root={tmp_path / 'nowhere'}"])
