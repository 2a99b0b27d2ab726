"""Stage-1 ground-mask pretraining in the port against the JAX package.

`ground_mask_gt`, the batch labels, `weighted_ce_ignore`, `binary_ce`,
`mask_iou`, `MaskIoUAccumulator` and `pe_ground_truth_mask` against their
JAX counterparts (rtol 1e-5); `GroundMaskPretrain` logits against the JAX
model on seeded JAX variables carried over by `load_flax_variables` (smoke
widths, f32, eval mode, rtol 1e-4, atol 1e-5); the backbone `.npz` read by
the other package both ways; `train(load_backbone_from=)` replaces the
backbone's parameters and nothing else before the first step; the
pretraining CLI on the CPU and its file fed to `tools.train`.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.eval import mask_iou as jiou
from gedepth_tpu.models import losses as jlosses
from gedepth_tpu.models import pretrain as jpre
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import load_flax_variables
from gedepth_tpu_torch.eval import mask_iou as tiou
from gedepth_tpu_torch.models import losses as tlosses
from gedepth_tpu_torch.models import pretrain as tpre

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

H, W = 64, 128


def _pe_gt(rng, shape=(2, 16, 24)):
    gt = rng.uniform(1.0, 80.0, shape).astype(np.float32)
    pe = (gt * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    gt[rng.random(shape) < 0.3] = 0.0
    pe[rng.random(shape) < 0.1] = -5.0
    return pe, gt


def test_ground_mask_gt_and_labels_match_jax():
    pe, gt = _pe_gt(np.random.default_rng(0))
    want = jpre.ground_mask_gt(pe, gt)
    np.testing.assert_array_equal(tpre.ground_mask_gt(pe, gt), want)
    assert 0 < want.mean() < 1
    # the batch labels of the JAX tool (tools/pretrain_pe_mask.py): the
    # raw prior in channel 4 against the lidar depth at 3%
    img = np.zeros(pe.shape + (5,), np.float32)
    img[..., 4] = pe
    err = jnp.abs(jnp.asarray(pe) - gt) / jnp.maximum(gt, 1e-6)
    jlabels = jnp.where((gt > 0) & (err <= 0.03), 1.0, 0.0)
    got = tpre.mask_labels(torch.from_numpy(img), torch.from_numpy(gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlabels))


def test_weighted_ce_and_binary_ce_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 8, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (2, 6, 8)).astype(np.float32)
    labels[0, 0, :3] = 255
    got = tpre.weighted_ce_ignore(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    want = jpre.weighted_ce_ignore(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    ref = torch.nn.CrossEntropyLoss(weight=torch.tensor([0.2, 1.0]),
                                    ignore_index=255)(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-5)

    x = rng.standard_normal((2, 6, 8)).astype(np.float32) * 4
    t = (rng.random((2, 6, 8)) < 0.4).astype(np.float32)
    valid = rng.random((2, 6, 8)) < 0.7
    for v in (None, valid):
        got = tlosses.binary_ce(torch.from_numpy(x), torch.from_numpy(t),
                                None if v is None else torch.from_numpy(v))
        want = jlosses.binary_ce(jnp.asarray(x), jnp.asarray(t),
                                 None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_mask_iou_matches_jax():
    rng = np.random.default_rng(2)
    pe, gt = _pe_gt(rng, (3, 20, 30))
    tacc, jacc = tiou.MaskIoUAccumulator(), jiou.MaskIoUAccumulator()
    assert tacc.summary().keys() == jacc.summary().keys()
    for i in range(3):
        want_gt = jiou.pe_ground_truth_mask(pe[i], gt[i])
        np.testing.assert_array_equal(tiou.pe_ground_truth_mask(pe[i], gt[i]),
                                      want_gt)
        pred = rng.random(want_gt.shape) < 0.5
        assert tiou.mask_iou(pred, want_gt) == jiou.mask_iou(pred, want_gt)
        tacc.add(pred, want_gt)
        jacc.add(pred, want_gt)
    tacc.add(np.ones((4, 4)), np.ones((4, 4)))      # 100: both buckets
    jacc.add(np.ones((4, 4)), np.ones((4, 4)))
    assert tacc.summary() == jacc.summary()


@pytest.fixture(scope="module")
def models():
    """(JAX GroundMaskPretrain, its seeded variables, the port's model on
    the same weights), smoke widths."""
    mc = jax_get_config("smoke_synthetic").model
    jmodel = jpre.GroundMaskPretrain(
        embed_dims=mc.embed_dims, depths=mc.depths, num_heads=mc.num_heads,
        window=mc.window, drop_path_rate=mc.drop_path_rate,
        neck_channels=mc.neck_channels, neck_embed_dim=mc.neck_embed_dim,
        neck_num_points=mc.neck_num_points)
    variables = jax.device_get(_random_variables(
        jmodel.init, jnp.zeros((1, H, W, 5)), seed=3))
    tmodel = tpre.GroundMaskPretrain.from_config(
        get_config("smoke_synthetic").model)
    load_flax_variables(tmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


def test_ground_mask_pretrain_matches_jax(models):
    jmodel, variables, tmodel = models
    assert tmodel.neck.sampling == "bilinear"
    img = np.random.default_rng(4).standard_normal((2, H, W, 5)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, H, W, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_backbone_npz_both_ways(models, tmp_path):
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.convert import state_dict_from_flax

    _, variables, tmodel = models
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax_backbone.npz")
    jckpt.save_params_only(jpath, jpre.extract_backbone(variables["params"]))
    got = tpre.load_backbone(jpath)
    want = tpre.extract_backbone(tmodel)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    # the port writes, the JAX package reads
    tpath = str(tmp_path / "port_backbone.npz")
    tpre.save_backbone(tpath, tmodel)
    with np.load(tpath) as data:
        assert all(k.startswith("params/backbone/") for k in data.files)
    back, _ = jckpt.load_params_only(
        tpath, {"backbone": variables["params"]["backbone"]})
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree.leaves({"backbone": variables["params"]["backbone"]})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    # and onto the JAX depth model's tree
    merged = jpre.overlay_backbone(
        {"backbone": variables["params"]["backbone"]}, back)
    assert set(state_dict_from_flax(merged)) == set(want)


def test_overlay_checks_names_and_shapes(models):
    _, _, tmodel = models
    depth = get_config("smoke_synthetic").model.build()
    backbone = tpre.extract_backbone(tmodel)
    with pytest.raises(ValueError, match="missing"):
        tpre.overlay_backbone(depth, dict(list(backbone.items())[1:]))
    bad = dict(backbone)
    bad["backbone.bn1.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shapes"):
        tpre.overlay_backbone(depth, bad)


def _smoke():
    cfg = get_config("smoke_synthetic")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, crop_size=(H, W), eval_size=(H, W), synthetic_size=4))


def test_load_backbone_from_changes_only_the_backbone(models, tmp_path,
                                                      monkeypatch):
    import gedepth_tpu_torch.train.loop as loop

    _, _, tmodel = models
    path = str(tmp_path / "b.npz")
    tpre.save_backbone(path, tmodel)
    cfg = _smoke()
    seeded = cfg.model.build(generator=torch.Generator().manual_seed(
        cfg.train.seed)).state_dict()
    before = []
    real = loop.make_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def first(state, batch):
            if not before:
                before.append({k: v.clone()
                               for k, v in state.model.state_dict().items()})
            return step(state, batch)
        return first

    monkeypatch.setattr(loop, "make_train_step", recording)
    loop.train(cfg, max_iters=1, eval_max_images=1, load_backbone_from=path,
               device="cpu")
    backbone = tpre.extract_backbone(tmodel)
    for key, value in before[0].items():
        want = backbone.get(key, seeded[key])
        assert torch.equal(value, want), key
    assert sum(not torch.equal(seeded[k], v) for k, v in backbone.items()) \
        == len(backbone)


def test_pretrain_cli_then_train(tmp_path, capsys):
    from gedepth_tpu_torch.tools import pretrain_pe_mask
    from gedepth_tpu_torch.tools import train as train_cli

    work = tmp_path / "pre"
    opts = ["--options", "data.crop_size=(64,128)",
            "data.eval_size=(64,128)", "data.synthetic_size=4"]
    pretrain_pe_mask.main(["smoke_synthetic", "--device", "cpu",
                           "--max-iters", "2", "--work-dir", str(work)]
                          + opts)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["n"] == 4 * 2 and 0 <= line["miou"] <= 100
    assert line["iters"] == 2 and line["step_ms"] > 0
    assert any(s.startswith("ground-mask IoU: miou=") for s in out)
    log = [json.loads(s) for s in
           (work / "train.log.jsonl").read_text().splitlines()]
    assert [r["mode"] for r in log] == ["train", "val"]
    assert np.isfinite(log[0]["mask_ce"])
    npz = str(work / "pe_mask_backbone.npz")
    assert line["backbone"] == npz
    train_cli.main(["smoke_synthetic", "--device", "cpu", "--max-iters", "1",
                    "--eval-max-images", "1", "--load-backbone-from", npz,
                    "--work-dir", str(tmp_path / "train")] + opts)
    out = capsys.readouterr().out
    assert f"overlaid the backbone from {npz}" in out
    assert json.loads(out.strip().splitlines()[-1])["iter"] == 1
