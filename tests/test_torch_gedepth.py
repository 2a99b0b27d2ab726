"""The PyTorch port's serving slice against the JAX package, end to end.

Smoke widths (`smoke_synthetic`) with the `gedepth_adaptive_kitti_tpu` neck
(windowed sampling, hi_min_level=1), scanned and unscanned Swin trees. The
JAX model's variables are seeded numpy values, carried over with
`state_dict_from_flax`, and both models run on the same inputs on the CPU. The JAX windowed neck runs its XLA `tiled` reference there.

Tolerance: f32 on both sides, rtol 1e-4 (the torch-parity tolerance of
tests/test_parity_torch.py), atol 1e-5 on the unitless outputs (y, logits)
and 1e-3 m on the metre-valued ones (depth, pe_mask). The outputs sum ~60
layers of f32 rounding taken in other orders (~1e-6 relative), and the
adaptive prior off = h / (h/pe + t) amplifies a rounding of the slope t by
off²/h: ~2e-4 m at off = 114 m is measured at this size. A layout or
convention fault shows at 1e-2 and above.
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
H, W = 64, 128


def _random_variables(init_fn, *args, seed=0):
    """Seeded numpy values for every leaf of a flax init's variable tree
    (shapes from `jax.eval_shape`, so no JAX init runs). Zero-init layers
    such as the offset and weight projections carry signal; BN variances
    stay positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], s.shape
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        if name == "mean":
            return rng.normal(0, 0.1, shape)
        if name == "scale":
            return 1 + rng.normal(0, 0.1, shape)
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(shape[:-1]))
            if "sampling_offsets" in names:
                std *= 3   # offsets of a few level pixels, some past R
            return rng.normal(0, std, shape)
        if name == "level_embed":
            return rng.normal(0, 1.0, shape)
        if name == "relative_position_bias_table":
            return rng.normal(0, 0.5, shape)
        return rng.normal(0, 0.05, shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _configs(swin_scan):
    over = dict(neck_sampling="windowed", neck_hi_min_level=1)
    jcfg = jax_get_config("smoke_synthetic")
    tcfg = get_config("smoke_synthetic")
    return (dataclasses.replace(jcfg.model, swin_scan=swin_scan, **over),
            dataclasses.replace(tcfg.model, **over))


def _sample(rng, h, w):
    img = rng.standard_normal((1, h, w, 5)).astype(np.float32)
    img[..., 3] = rng.uniform(0, 1, (1, h, w))
    # raw PE in metres, away from the validity edges 0 and depth_scale
    img[..., 4] = rng.uniform(2.0, 80.0, (1, h, w))
    return img


@pytest.mark.parametrize("swin_scan", [False, True])
def test_gedepth_forward_matches_jax(swin_scan):
    jmodel_cfg, tmodel_cfg = _configs(swin_scan)
    jmodel = jmodel_cfg.build()
    img = _sample(np.random.default_rng(0), H, W)
    cam = np.asarray([1.6], np.float32)
    variables = _random_variables(jmodel.init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=1)
    if swin_scan:
        assert any(k.endswith("_pairs") for k in variables["params"]
                   ["backbone"])
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img),
                                 jnp.asarray(cam))
    want_pred = jax.jit(functools.partial(
        jmodel.apply, method=jmodel.predict_depth))(
            variables, jnp.asarray(img), jnp.asarray(cam))

    tmodel = tmodel_cfg.build()
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(img), torch.from_numpy(cam))
        got_pred = tmodel.predict_depth(torch.from_numpy(img),
                                        torch.from_numpy(cam))
    for key, atol in (("depth", 1e-3), ("y", 1e-5), ("slope_logits", 1e-5),
                      ("pe_mask", 1e-3)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=atol, err_msg=key)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-3)


def test_inference_depther_flip_tta_matches_jax():
    """One synthetic 5-channel sample through both `inference_depther`s
    (normalisation, forward, flip-TTA, clamp, resize)."""
    from gedepth_tpu.apis.inference import (
        DeptherHandle, inference_depther as jax_infer)
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu.eval.evaluator import build_test_pipeline
    from gedepth_tpu.train.steps import make_eval_step
    from gedepth_tpu_torch.apis import inference_depther, init_depther

    over = dict(neck_sampling="windowed", neck_hi_min_level=1)
    jcfg = jax_get_config("smoke_synthetic")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, swin_scan=True,
                                                  **over))
    tcfg = get_config("smoke_synthetic")
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **over))
    jmodel = jcfg.model.build()
    variables = _random_variables(
        jmodel.init, jnp.zeros((1, 96, 192, 5)), jnp.ones((1,)), seed=2)
    # the handle `gedepth_tpu.apis.inference.init_depther` builds, with
    # these weights in place of its initialisation
    jh = DeptherHandle(jcfg, jmodel, variables["params"],
                       variables["batch_stats"],
                       make_eval_step(jmodel, flip_tta=True),
                       build_test_pipeline(jcfg.data))
    sample = SyntheticGroundDataset(size=1, height=96, width=192)[0]
    image = sample["img"]
    want = jax_infer(jh, image.copy(), cam_height=1.6)

    th = init_depther(tcfg, device="cpu", state_dict=state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    got = inference_depther(th, image.copy(), cam_height=1.6)
    assert got.shape == want.shape == (96, 192)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_port_init_matches_jax_init_rules():
    """The port's own init: windowed offset bias scaled by R/P, zero
    offset/weight kernels, BN statistics 0/1 — as the JAX init."""
    from gedepth_tpu.models.hahi import _msda_offset_bias_init

    _, tmodel_cfg = _configs(True)
    m = tmodel_cfg
    sd = tmodel_cfg.build().state_dict()
    h, L, P = 8, 4, m.neck_num_points
    jax_bias = _msda_offset_bias_init(h, L, P, m.neck_window_radius / P)(
        None, (h * L * P * 2,))
    for tmod in ("self_attn", "multi_att"):
        np.testing.assert_array_equal(
            sd[f"neck.{tmod}.sampling_offsets.bias"].numpy(),
            np.asarray(jax_bias))
        for name in ("sampling_offsets", "attention_weights"):
            assert not sd[f"neck.{tmod}.{name}.weight"].any()
        assert not sd[f"neck.{tmod}.attention_weights.bias"].any()
    assert (sd["backbone.bn1.running_var"] == 1).all()
    assert not sd["backbone.bn1.running_mean"].any()
    # same seed, same weights; another seed, other weights
    a = tmodel_cfg.build(generator=torch.Generator().manual_seed(3))
    b = tmodel_cfg.build(generator=torch.Generator().manual_seed(3))
    c = tmodel_cfg.build(generator=torch.Generator().manual_seed(4))
    key = "backbone.stages.0.blocks.0.attn.w_msa.qkv.weight"
    assert torch.equal(a.state_dict()[key], b.state_dict()[key])
    assert not torch.equal(a.state_dict()[key], c.state_dict()[key])


# fields of the JAX dataclasses that the port leaves out on purpose
LEFT_OUT = {
    # the JAX parameter layout, remat (memory only), a negative result, and
    # the zoo's architecture fields
    "model": {"swin_scan", "swin_remat", "neck_msda_remat", "neck_value_bf16",
              "arch", "backbone_variant", "backbone_embed_dims",
              "backbone_depth", "n_bins"},
    # NYU's scene classes (the zoo's BinsFormer)
    "data": {"scene_classes"},
    # the zoo's loss composition
    "optim": {"aux_loss_indices", "aux_loss_weights", "class_ce_weight",
              "chamfer_weight"},
    # multi-process loading is not ported yet
    "train": {"num_workers", "sampling"},
}

REFERENCE_PRESETS = ("gedepth_adaptive_kitti",
                     "gedepth_adaptive_kitti_compat",
                     "gedepth_adaptive_kitti_parity",
                     "gedepth_vanilla_kitti", "depthformer_baseline_kitti",
                     "gedepth_vanilla_ddad", "gedepth_adaptive_ddad",
                     "gedepth_adaptive_ddad_tpu")


def _assert_preset_matches_jax(name):
    """Field by field: every field of the JAX preset is either in the port
    with the same value, or listed in LEFT_OUT; the port adds none."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    assert tcfg.name == jcfg.name == name
    assert tcfg.work_dir == jcfg.work_dir
    for part in ("model", "data", "optim", "train"):
        tpart, jpart = getattr(tcfg, part), getattr(jcfg, part)
        tnames = {f.name for f in dataclasses.fields(tpart)}
        jnames = {f.name for f in dataclasses.fields(jpart)}
        assert tnames <= jnames, (part, tnames - jnames)
        assert jnames - tnames == LEFT_OUT[part], (part, jnames - tnames)
        for f in tnames:
            assert getattr(tpart, f) == getattr(jpart, f), (name, part, f)


def test_presets_match_jax():
    for name in ("gedepth_adaptive_kitti_tpu", "smoke_synthetic"):
        _assert_preset_matches_jax(name)


@pytest.mark.parametrize("name", REFERENCE_PRESETS)
def test_reference_presets_match_jax(name):
    _assert_preset_matches_jax(name)


def test_unsupported_modes_raise():
    _, tmodel_cfg = _configs(False)
    with pytest.raises(ValueError, match="bf16_scope"):
        dataclasses.replace(tmodel_cfg, bf16_scope="neck").build()
    for over in (dict(neck_sampling="bicubic"), dict(pe_variant="learned")):
        with pytest.raises(ValueError):
            dataclasses.replace(tmodel_cfg, **over).build()
    with pytest.raises(KeyError):
        get_config("gedepth_adaptive_kitti_fp8")       # no such preset


def test_port_imports_neither_jax_nor_gedepth_tpu():
    """`import gedepth_tpu_torch` and every submodule loads no JAX, nothing
    of `gedepth_tpu`, and none of PIL, cv2 and matplotlib (the card's
    machine has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gedepth_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'gedepth_tpu', 'PIL', 'cv2', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('gedepth_tpu_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
