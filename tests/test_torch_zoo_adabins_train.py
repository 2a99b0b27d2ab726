"""`ZooDepther` 'adabins' trained and its weights carried, against the JAX
package, and `adabins_nyu` through the port's entry points, on the CPU:
one `make_zoo_train_step` step at chamfer_weight 0 and 0.1, the
params-only `.npz` both ways, and tools.train, tools.test and the exported
eval step at smoke width.

Widths and tolerances as tests/test_torch_zoo_adabins.py's (b0, head 8,
16 bins, 192x256 frames: 3x4 patches for 8 range queries).
"""
import dataclasses
import json
import os

import numpy as np
import torch
import jax.numpy as jnp

from gedepth_tpu_torch.configs import apply_options, get_config

from test_torch_zoo import _close
from test_torch_zoo_adabins import _adabins
from test_torch_zoo_dpt import image, model_configs

torch.set_num_threads(1)

OPTS = ["data.dataset=synthetic", "data.synthetic_size=4",
        "data.crop_size=(64,128)", "data.eval_size=(64,128)",
        "train.global_batch=2", "train.eval_interval=2",
        "train.checkpoint_interval=2", "train.log_interval=1",
        "optim.warmup_iters=1", "model.head_channels=8", "model.n_bins=16"]


def _nyu_like_batch(h=192, w=256, seed=0):
    """A batch of 2 synthetic frames cropped to h x w (RGB and the GT)."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(h, w))
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=h, width=w,
                                                max_depth=10.0, use_pe=False),
                         build_train_pipeline(data), 2, seed=seed)
    return loader.make_batch(0)


def test_zoo_adabins_train_step_matches_jax():
    """One step of `make_zoo_train_step` at chamfer_weight 0 and 0.1 (b0,
    head 8, 16 bins, 192x256, batch 2): loss and its terms, the raw
    gradients of both, the gradient norm, then the parameters and
    BatchNorm statistics after the 0.1 step, against the JAX step."""
    from test_torch_zoo_dpt import zoo_step_against_jax

    batch = _nyu_like_batch()
    results = zoo_step_against_jax("adabins_nyu", batch, (0.0, 0.1),
                                   head_channels=8, n_bins=16)
    assert "loss_chamfer" not in results[0.0]
    with_chamfer = results[0.1]
    assert with_chamfer["loss_chamfer"].item() > 0
    np.testing.assert_allclose(
        with_chamfer["loss"].item(), with_chamfer["loss_depth"].item()
        + with_chamfer["loss_chamfer"].item(), rtol=1e-6)


def test_zoo_adabins_npz_both_ways(tmp_path):
    """The port's `.npz` in the JAX `load_params_only` (the JAX model then
    gives the port's depth and edges) and a JAX `.npz` in the port; and a
    JAX model built at a frame with fewer patches than range queries
    (conv_out with 1 input at 64x128) loads into the port, which gives its
    depth at that size."""
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.train import checkpoint as tckpt

    img = image(seed=10, batch=1, h=192, w=256, channels=3)
    jmodel, variables, tmodel = _adabins(img, seed=11)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"],
                           variables["batch_stats"])
    _, tcfg = model_configs("adabins_nyu", head_channels=8, n_bins=16)
    loaded = tckpt.load_params_only(path, tcfg.build())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    path = str(tmp_path / "port.npz")
    tmodel = tcfg.build(generator=torch.Generator().manual_seed(12))
    tckpt.save_params_only(path, tmodel)
    params, stats = jckpt.load_params_only(path, variables["params"],
                                           variables["batch_stats"])
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    _close(got["bin_edges"].numpy(), want["bin_edges"])

    small = image(seed=13, batch=1, h=64, w=128, channels=3)
    jmodel, variables, tmodel = _adabins(small, seed=14)
    assert variables["params"]["decode_head"]["conv_out"]["kernel"].shape[
        2] == 1
    path = str(tmp_path / "narrow.npz")
    jckpt.save_params_only(path, variables["params"],
                           variables["batch_stats"])
    loaded = tckpt.load_params_only(path, tcfg.build())
    w = loaded.state_dict()["decode_head.conv_out.0.weight"]
    assert w.shape == (16, 8, 1, 1) and not w[:, 1:].any()
    want = jmodel.apply(variables, jnp.asarray(small))
    with torch.no_grad():
        got = loaded(torch.from_numpy(small))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_zoo_adabins_cli(tmp_path, capsys):
    """tools.train in f32, then --bf16-compute with chamfer_weight 0.1
    resuming its checkpoint (64x128 synthetic frames: 2 patches, 1 range
    query), tools.test with flip-TTA and --slide on the best `.npz`, and
    the exported eval step against the eager one."""
    from gedepth_tpu_torch.apis.export import export_depther
    from gedepth_tpu_torch.apis.inference import init_depther
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    work = tmp_path / "adabins"
    base = ["adabins_nyu", "--device", "cpu", "--work-dir", str(work),
            "--eval-max-images", "1"]
    train_cli.main(base + ["--max-iters", "2", "--options", *OPTS])
    best = _last_json(capsys)
    assert best["iter"] == 2 and np.isfinite(best["abs_rel"])
    train_cli.main(base + ["--max-iters", "3", "--bf16-compute",
                           "--resume-from", str(work / "ckpts"),
                           "--options", *OPTS, "optim.chamfer_weight=0.1"])
    capsys.readouterr()
    records = [json.loads(line) for line in
               (work / "train.log.jsonl").read_text().splitlines()]
    train = [r for r in records if r["mode"] == "train"]
    assert [r["iter"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert "loss_chamfer" not in train[0] and train[2]["loss_chamfer"] > 0
    assert sorted(os.listdir(work)) == ["best_abs_rel.npz", "ckpts", "tb",
                                        "train.log.jsonl"]
    npz = str(work / "best_abs_rel.npz")
    for flags in ([], ["--slide"]):
        test_cli.main(["adabins_nyu", npz, "--device", "cpu",
                       "--max-images", "2", *flags, "--options", *OPTS])
        line = _last_json(capsys)
        assert line["images"] == 2 and np.isfinite(line["abs_rel"]), flags

    cfg = apply_options(get_config("adabins_nyu"), OPTS)
    exported, weights, meta = export_depther(cfg, hw=(64, 128),
                                             flip_tta=True, device="cpu",
                                             checkpoint=npz)
    assert meta["ops"] == [] and meta["input"]["img"] == [1, 64, 128, 5]
    img = torch.from_numpy(image(seed=18, batch=1))
    cam = torch.full((1,), 1.65)
    with torch.no_grad():
        got = exported.module()(weights, img, cam)
    want = init_depther(cfg, device="cpu", flip_tta=True,
                        checkpoint=npz).eval_step(img, cam)
    assert torch.equal(got, want)
