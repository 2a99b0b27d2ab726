"""The port's EfficientNets, AdaBins head, bin-chamfer loss and
`ZooDepther` 'adabins' against the JAX package, on the CPU.

Seeded numpy variables for the JAX modules, carried to the port by
`state_dict_from_flax` / `load_flax_variables`; the same seeded inputs
through both. EfficientNet-b0 at its own widths; timm's EfficientNet at
half B5's width and depth ('tf_test', registered in both packages' scale
tables); the AdaBins head at 8-16 channels and 16-32 bins.

Token counts: the mini-ViT takes one patch of 16 at the head's /4 map (b0)
as its bins token and the next `channels` as range queries. The port's
`conv_out` always has `channels` inputs; the JAX package builds it with as
many as the first call had queries. Inputs here give at least channels + 1
patches, so both trees have one shape, except where the fewer-queries rule
itself is under test.

Tolerances as tests/test_torch_zoo.py's: rtol 1e-4 with atol 1e-5 of each
output's largest value for features and BatchNorm statistics (train-mode
features and statistics within JAX's own distance from a float64 run on
top), 1e-3 m for depth, and the bin edges as features.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_gedepth import _random_variables
from test_torch_zoo import _assert_stats_match, _close, _double_copy
from test_torch_zoo_dpt import _strip, bridged, image, model_configs

torch.set_num_threads(1)

HALF_B5 = (0.5, 0.5)


@pytest.fixture
def tf_test(monkeypatch):
    """'tf_test': timm's EfficientNet at half B5's width and depth, in both
    packages."""
    from gedepth_tpu.models import efficientnet as jeff
    from gedepth_tpu_torch.models import efficientnet as teff

    monkeypatch.setitem(jeff._TIMM_SCALES, "tf_test", HALF_B5)
    monkeypatch.setitem(teff.TIMM_SCALES, "tf_test", HALF_B5)
    return "tf_test"


def _features_match(jmodel, variables, tmodel, img, prefix):
    """Eval-mode and train-mode endpoints of a backbone, and its train-mode
    BatchNorm statistics, against the JAX module's."""
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    want = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel.eval()(x)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy().transpose(0, 2, 3, 1), w, err_msg=f"eval {i}")

    want, mutated = jmodel.apply(variables, jnp.asarray(img), True,
                                 mutable=["batch_stats"])
    f64 = _double_copy(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
        ref = f64(x.double())
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        g = g.numpy().transpose(0, 2, 3, 1)
        w, r = np.asarray(w), r.numpy().transpose(0, 2, 3, 1)
        jax_err = float(np.abs(w - r).max())
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()) + jax_err,
            err_msg=f"train {i}")
    _assert_stats_match(tmodel, mutated["batch_stats"], f64, prefix)
    return got


def test_efficientnet_b0_matches_jax():
    """b0's four endpoints (/4 to /32: 24, 40, 112, 320 channels)."""
    from gedepth_tpu.models.efficientnet import EfficientNet as JaxEff
    from gedepth_tpu_torch.models.efficientnet import EfficientNet

    img = image(seed=1, h=64, w=96, channels=3)
    jmodel = JaxEff("b0")
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=2)
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables["batch_stats"]})
    tmodel = EfficientNet("b0")
    assert tmodel.channels == [24, 40, 112, 320]
    tmodel.load_state_dict(_strip(sd, "backbone."), strict=True)
    got = _features_match(jmodel, variables, tmodel, img, "backbone.")
    assert [tuple(g.shape[2:]) for g in got] == [(16, 24), (8, 12), (4, 6),
                                                 (2, 3)]


def test_timm_efficientnet_matches_jax(tf_test):
    """The five endpoints (stages 0, 1, 2, 4 and the raw conv_head) at
    66x98, where TF 'SAME' padding is asymmetric."""
    from gedepth_tpu.models.efficientnet import TimmEfficientNet as JaxTimm
    from gedepth_tpu_torch.models.efficientnet import TimmEfficientNet

    img = image(seed=3, h=66, w=98, channels=3)
    jmodel = JaxTimm(tf_test)
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=4)
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables["batch_stats"]})
    tmodel = TimmEfficientNet(tf_test)
    tmodel.load_state_dict(_strip(sd, "backbone."), strict=True)
    got = _features_match(jmodel, variables, tmodel, img, "backbone.")
    assert [g.shape[1] for g in got] == tmodel.channels


def _head_inputs(seed, h, w, batch=2):
    """A b0-shaped pyramid of an h x w input (/4 to /32), NHWC."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h // s, w // s, c)).astype(
        np.float32) for s, c in zip((4, 8, 16, 32), (24, 40, 112, 320))]


def _heads(feats, channels, n_bins, seed):
    from gedepth_tpu.models.adabins import AdabinsHead as JaxHead
    from gedepth_tpu_torch.models.adabins import AdabinsHead

    widths = tuple(channels * 2 ** i for i in range(4))
    jhead = JaxHead(up_sample_channels=widths, channels=channels,
                    n_bins=n_bins)
    jin = [jnp.asarray(f) for f in feats]
    variables = _random_variables(jhead.init, jin, seed=seed)
    head = AdabinsHead((24, 40, 112, 320), widths, channels=channels,
                       n_bins=n_bins).eval()
    return jhead, jin, variables, head


def test_adabins_head_matches_jax():
    """The head at 16 channels and 32 bins on the pyramid of a 256x320
    frame (/4: 64x80, 20 patches, 16 range queries): depth and bin edges
    (monotone, from min_depth to max_depth)."""
    feats = _head_inputs(5, 256, 320)
    jhead, jin, variables, head = _heads(feats, 16, 32, 6)
    sd = state_dict_from_flax({"decode_head": variables["params"]})
    head.load_state_dict(_strip(sd, "decode_head."), strict=True)
    want_d, want_e = jhead.apply(variables, jin)
    with torch.no_grad():
        got_d, got_e = head([torch.from_numpy(f.transpose(0, 3, 1, 2).copy())
                             for f in feats])
    assert got_e.shape == (2, 33) and got_d.shape == (2, 1, 64, 80)
    _close(got_e.numpy(), want_e, err_msg="edges")
    _close(got_d.numpy().transpose(0, 2, 3, 1), want_d, err_msg="depth")
    e = got_e.numpy()
    assert (np.diff(e, axis=1) > 0).all()
    np.testing.assert_allclose(e[:, 0], 1e-3, rtol=1e-6)
    np.testing.assert_allclose(e[:, -1], 10.0, rtol=1e-5)


def test_adabins_fewer_queries_is_the_jax_head_at_that_size():
    """A 128x192 frame gives 2x3 patches, 5 range queries for 16 channels:
    the JAX head builds conv_out with 5 inputs; the port's first 5 of its
    16 take them, and the other 11 change nothing. Outside 2..500 patches
    the port raises."""
    feats = _head_inputs(7, 128, 192)
    jhead, jin, variables, head = _heads(feats, 16, 32, 8)
    sd = _strip(state_dict_from_flax({"decode_head": variables["params"]}),
                "decode_head.")
    narrow = sd["conv_out.0.weight"]
    assert narrow.shape == (32, 5, 1, 1)
    sd["conv_out.0.weight"] = torch.cat(
        [narrow, torch.randn(32, 11, 1, 1)], dim=1)
    head.load_state_dict(sd, strict=True)
    want_d, want_e = jhead.apply(variables, jin)
    x = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats]
    with torch.no_grad():
        got_d, got_e = head(x)
    _close(got_e.numpy(), want_e, err_msg="edges")
    _close(got_d.numpy().transpose(0, 2, 3, 1), want_d, err_msg="depth")

    patch = head.adaptive_bins_layer.patch_transformer
    for h, w in ((16, 16), (16 * 21, 16 * 24)):     # 1 and 504 patches
        with pytest.raises(ValueError, match="patches"):
            patch(torch.zeros(1, 16, h, w))


def _chamfer_case(seed, valid_frac):
    rng = np.random.default_rng(seed)
    widths = rng.uniform(0.1, 1.0, (3, 16))
    edges = np.concatenate([np.full((3, 1), 1e-3),
                            1e-3 + np.cumsum(widths / widths.sum(
                                1, keepdims=True) * 10.0, axis=1)], axis=1)
    gt = rng.uniform(0.2, 10.0, (3, 12, 16))
    gt[rng.uniform(size=gt.shape) > valid_frac] = 0.0
    return edges.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("valid_frac", [0.0, 0.3, 1.0])
def test_bins_chamfer_loss_matches_jax(valid_frac):
    """No valid target (both directions 0), some, and all; a row of the
    partial case emptied as well. The value and the gradient with respect
    to the bin edges."""
    from gedepth_tpu.models.losses_extra import bins_chamfer_loss as jloss
    from gedepth_tpu_torch.models.losses import bins_chamfer_loss

    edges, gt = _chamfer_case(int(valid_frac * 10), valid_frac)
    if valid_frac == 0.3:
        gt[1] = 0.0
    want, want_g = jax.value_and_grad(lambda e: jloss(
        e, jnp.asarray(gt), min_depth=1e-3, loss_weight=0.1))(
            jnp.asarray(edges))
    e = torch.from_numpy(edges).requires_grad_()
    got = bins_chamfer_loss(e, torch.from_numpy(gt)[..., None],
                            min_depth=1e-3, loss_weight=0.1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-7)
    _close(e.grad.numpy(), want_g, err_msg="grad")
    if valid_frac == 0.0:
        assert got.item() == 0.0


def _adabins(img, seed=1, **over):
    return bridged("adabins_nyu", img, seed=seed,
                   **dict(dict(head_channels=8, n_bins=16), **over))


def test_zoo_adabins_matches_jax():
    """`ZooDepther` 'adabins' (b0, head 8, 16 bins) on 3-channel 192x256
    frames (3x4 patches, 8 queries): eval depth, bin edges,
    `predict_depth`; the train-mode forward and its BatchNorm statistics."""
    img = image(seed=9, h=192, w=256, channels=3)
    jmodel, variables, tmodel = _adabins(img)
    x = torch.from_numpy(img)
    want = jmodel.apply(variables, jnp.asarray(img))
    want_pred = jmodel.apply(variables, jnp.asarray(img),
                             method=jmodel.predict_depth)
    with torch.no_grad():
        got = tmodel(x)
        got_pred = tmodel.predict_depth(x)
    assert got["depth"].shape == (2, 48, 64, 1)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    _close(got["bin_edges"].numpy(), want["bin_edges"], err_msg="edges")
    assert got_pred.shape == (2, 192, 256, 1)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-3)

    want, mutated = jmodel.apply(variables, jnp.asarray(img), None, True,
                                 mutable=["batch_stats"])
    f64 = _double_copy(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
        f64(x.double())
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    _assert_stats_match(tmodel, mutated["batch_stats"], f64)


def test_zoo_adabins_decay_mask_matches_jax():
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu_torch.train import optim as toptim

    jcfg, tcfg = model_configs("adabins_nyu", head_channels=8, n_bins=16)
    variables = _random_variables(jcfg.build().init,
                                  jnp.zeros((1, 192, 256, 3)), None)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda d, p: np.full(np.shape(p), float(d)),
        joptim.decay_mask(variables["params"]), variables["params"]))
    names = {n for n, _ in tcfg.build().named_parameters()}
    assert set(want) == names
    assert any(not toptim.decays(n) for n in names)      # the encoder LNs
    for name in names:
        assert toptim.decays(name) == bool(want[name].all()), name


def test_zoo_adabins_pth_loads_as_the_jax_converter(tmp_path, tf_test):
    """A reference AdaBins `.pth`: timm's EfficientNet under
    `backbone.original_model.` (half B5) and the textbook head under
    `decode_head.` (head 8, 16 bins). Both packages map every key (the
    timm head's `bn2` and `classifier` dropped) and give the same depth and
    edges from it at 96x128 (the head's /2 map: 3x4 patches, 8 queries)."""
    from gedepth_tpu.convert import convert_state_dict as jax_convert
    from gedepth_tpu.convert.torch_to_jax import _merge_into
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file
    from gedepth_tpu_torch.models.efficientnet import TimmEfficientNet
    from test_torch_zoo2_textbook import TAdabinsHead, TTimmEffNet

    torch.manual_seed(15)
    backbone = TTimmEffNet(*HALF_B5)
    channels = TimmEfficientNet(tf_test).channels           # fine to coarse
    head = TAdabinsHead(channels[::-1], (128, 64, 32, 16, 8), e=8, nb=16)
    sd = {f"backbone.original_model.{k}": v
          for k, v in backbone.state_dict().items()}
    sd.update({f"decode_head.{k}": v for k, v in head.state_dict().items()})
    path = str(tmp_path / "adabins.pth")
    torch.save({"state_dict": sd}, path)

    img = image(seed=16, batch=1, h=96, w=128, channels=3)
    jmodel, variables, model = _adabins(img, seed=17,
                                        backbone_variant=tf_test)
    params, stats, jax_unmapped = jax_convert(
        {k: v.numpy() for k, v in sd.items()})
    jparams, missing_p = _merge_into(variables["params"], params)
    jstats, missing_s = _merge_into(variables["batch_stats"], stats)
    assert not missing_p and not missing_s and not jax_unmapped
    _, report = convert_checkpoint_file(path, model)
    assert report["unmapped_torch_keys"] == []
    assert report["unused_torch_keys"] == []
    assert not report["missing_params"] and not report["missing_stats"]
    want = jmodel.apply({"params": jparams, "batch_stats": jstats},
                        jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    _close(got["bin_edges"].numpy(), want["bin_edges"])
