"""The zoo presets through the port's entry points on the CPU, at tiny
widths (head_channels 8, ResNet-18, 64x128 synthetic frames):
`tools.train` (f32 and --bf16-compute, then --resume-from), `tools.test`
(flip, --aug-test, --slide) on the best `.npz`, `init_depther` /
`inference_depther` against the JAX package's serving path, the exported
program, and `tools.benchmark --train-step`.

Serving tolerance as tests/test_torch_gedepth.py's: rtol 1e-4, atol 1e-3 m.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gedepth_tpu_torch.configs import apply_options, get_config

torch.set_num_threads(1)

OPTS = ["data.dataset=synthetic", "data.synthetic_size=4",
        "data.crop_size=(64,128)", "data.eval_size=(64,128)",
        "train.global_batch=2", "train.eval_interval=2",
        "train.checkpoint_interval=2", "train.log_interval=1",
        "optim.warmup_iters=1", "model.head_channels=8",
        "model.backbone_variant=18"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,extra", [("bts_kitti", []),
                                        ("densedepth_kitti",
                                         ["--bf16-compute"])])
def test_zoo_train_resume_and_test_cli(name, extra, tmp_path, capsys):
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    work = tmp_path / name
    base = [name, "--device", "cpu", "--work-dir", str(work),
            "--eval-max-images", "1", *extra]
    train_cli.main(base + ["--max-iters", "2", "--options", *OPTS])
    best = _last_json(capsys)
    assert best["iter"] == 2 and np.isfinite(best["abs_rel"])
    assert sorted(os.listdir(work)) == ["best_abs_rel.npz", "ckpts", "tb",
                                        "train.log.jsonl"]
    train_cli.main(base + ["--max-iters", "3", "--resume-from",
                           str(work / "ckpts"), "--options", *OPTS])
    capsys.readouterr()
    records = [json.loads(line) for line in
               (work / "train.log.jsonl").read_text().splitlines()]
    train = [r for r in records if r["mode"] == "train"]
    assert [r["iter"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and "loss_slope" not in r
               for r in train)

    npz = str(work / "best_abs_rel.npz")
    for flags in ([], ["--aug-test", "--aug-ratios", "0.75,1.25"],
                  ["--slide"]):
        test_cli.main([name, npz, "--device", "cpu", "--max-images", "2",
                       *flags, "--options", *OPTS])
        line = _last_json(capsys)
        assert line["images"] == 2 and np.isfinite(line["abs_rel"]), flags


def _tiny(name):
    return apply_options(get_config(name), OPTS)


def test_zoo_serving_matches_jax():
    """One synthetic 5-channel sample through both `inference_depther`s
    (test pipeline, forward, flip-TTA, clamp, resize) on bridged weights."""
    from gedepth_tpu.apis.inference import (
        DeptherHandle, inference_depther as jax_infer)
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu.eval.evaluator import build_test_pipeline
    from gedepth_tpu.train.steps import make_eval_step
    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.convert import state_dict_from_flax
    from test_torch_gedepth import _random_variables

    tcfg = _tiny("bts_kitti")
    jcfg = jax_get_config("bts_kitti")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, head_channels=8,
                                  backbone_variant="18"),
        data=dataclasses.replace(jcfg.data, dataset="synthetic",
                                 eval_size=(64, 128)))
    jmodel = jcfg.model.build()
    variables = _random_variables(jmodel.init, jnp.zeros((1, 64, 128, 5)),
                                  None, seed=2)
    jh = DeptherHandle(jcfg, jmodel, variables["params"],
                       variables["batch_stats"],
                       make_eval_step(jmodel, flip_tta=True),
                       build_test_pipeline(jcfg.data))
    image = SyntheticGroundDataset(size=1, height=64, width=128)[0]["img"]
    assert image.shape[-1] == 5           # the preset keeps its PE channels
    want = jax_infer(jh, image.copy(), cam_height=1.6)
    th = init_depther(tcfg, device="cpu", flip_tta=True,
                      state_dict=state_dict_from_flax(
                          variables["params"], variables["batch_stats"]))
    got = inference_depther(th, image.copy(), cam_height=1.6)
    assert got.shape == want.shape == (64, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="plane embedding"):
        inference_depther(th, image[..., :3].copy())


@pytest.mark.parametrize("name", ["bts_kitti", "densedepth_kitti"])
def test_zoo_export_equals_eager(name):
    """The exported eval step: no port op in its graph (the zoo path runs
    no custom kernel), and the program's depth equal to the eager step's."""
    from gedepth_tpu_torch.apis.export import export_depther
    from gedepth_tpu_torch.apis.inference import init_depther

    cfg = _tiny(name)
    exported, weights, meta = export_depther(cfg, hw=(64, 128),
                                             flip_tta=True, device="cpu")
    assert meta["ops"] == [] and meta["input"]["img"] == [1, 64, 128, 5]
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 64, 128, 5)).astype(np.float32))
    cam = torch.full((1,), 1.65)
    with torch.no_grad():
        got = exported.module()(weights, img, cam)
    want = init_depther(cfg, device="cpu", flip_tta=True).eval_step(img, cam)
    assert torch.equal(got, want)


def test_zoo_benchmark_train_step(capsys):
    from gedepth_tpu_torch.tools import benchmark

    benchmark.main(["densedepth_kitti", "--device", "cpu", "--iters", "2",
                    "--warmup", "1", "--batch", "2", "--height", "64",
                    "--width", "128", "--train-step", "--options",
                    "model.head_channels=8", "model.backbone_variant=18"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert line["preset"] == "densedepth_kitti"
    assert line["mode"] == "train_step" and line["iters"] == 2
    assert line["host_ms_per_iter"] > 0
