"""Every PE variant and sampling mode of the PyTorch port's `GEDepth`
against the JAX package, end to end, on the CPU.

Smoke widths (`smoke_synthetic`) at 64x128: pe_variant in {none, vanilla,
adaptive} x neck_sampling in {bilinear, nearest, windowed, windowed_compat},
12 models, each with the JAX model's seeded numpy variables carried over by
`load_flax_variables` (strict). Then trees that do not fit their model.

Tolerances as tests/test_torch_gedepth.py: rtol 1e-4, atol 1e-5 on the
unitless outputs and 1e-3 m on the metre-valued ones; the baseline's depth,
relu(conv) + min_depth of ~1e-3 m with these weights, is held to atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.ops.resize import resize_bilinear
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import load_flax_variables

from test_torch_gedepth import _random_variables, _sample

torch.set_num_threads(1)

H, W = 64, 128
PE_VARIANTS = ("none", "vanilla", "adaptive")
SAMPLING = ("bilinear", "nearest", "windowed", "windowed_compat")


def _model_configs(pe_variant, sampling, **over):
    over = dict(pe_variant=pe_variant, neck_sampling=sampling, **over)
    return (dataclasses.replace(jax_get_config("smoke_synthetic").model,
                                **over),
            dataclasses.replace(get_config("smoke_synthetic").model, **over))


def _input(pe_variant, seed=0):
    img = _sample(np.random.default_rng(seed), H, W)
    return img[..., :3].copy() if pe_variant == "none" else img


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("pe_variant", PE_VARIANTS)
def test_gedepth_variants_match_jax(pe_variant, sampling):
    jcfg, tcfg = _model_configs(pe_variant, sampling)
    jmodel = jcfg.build()
    img, cam = _input(pe_variant), np.asarray([1.6], np.float32)
    variables = _random_variables(jmodel.init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=1)
    params = variables["params"]
    assert ("reference_points" in params["neck"]) == (sampling != "windowed")
    assert ("pe_mask_neck" in params) == (pe_variant != "none")
    assert ("dynamic_pe_neck" in params) == (pe_variant == "adaptive")
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img),
                                 jnp.asarray(cam))
    # what `predict_depth` adds to the forward (it is run whole, under jit,
    # in tests/test_torch_gedepth.py)
    want_pred = resize_bilinear(
        jnp.clip(want["depth"], jmodel.min_depth, jmodel.max_depth), (H, W),
        align_corners=True)

    tmodel = load_flax_variables(tcfg.build(), params,
                                 variables["batch_stats"])
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(img), torch.from_numpy(cam))
        got_pred = tmodel.predict_depth(torch.from_numpy(img),
                                        torch.from_numpy(cam))
    depth_atol = 1e-6 if pe_variant == "none" else 1e-3
    for key, atol in (("depth", depth_atol), ("y", 1e-5),
                      ("slope_logits", 1e-5), ("pe_mask", 1e-3)):
        if want[key] is None:
            assert got[key] is None, key
            continue
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=atol, err_msg=key)
    assert (want["y"] is None) == (pe_variant == "none")
    assert (want["slope_logits"] is None) == (pe_variant != "adaptive")
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=depth_atol)


def test_vanilla_multiplier_is_200_even_at_depth_scale_250():
    _, tcfg = _model_configs("vanilla", "windowed", depth_scale=250.0)
    model = tcfg.build()
    assert model.vanilla_pe_multiplier == 200.0
    img = torch.from_numpy(_input("vanilla"))
    with torch.inference_mode():
        out = model(img)
    torch.testing.assert_close(out["pe_mask"],
                               img[..., 3:4] * out["y"] * 200.0)


@pytest.mark.parametrize("tree,model,why", [
    (("adaptive", "bilinear"), ("adaptive", "windowed"), "sampling mode"),
    (("adaptive", "windowed"), ("adaptive", "windowed_compat"),
     "sampling mode"),
    (("vanilla", "bilinear"), ("adaptive", "bilinear"), "PE variant"),
    (("adaptive", "nearest"), ("vanilla", "nearest"), "PE variant"),
    (("none", "windowed"), ("vanilla", "windowed"), "PE variant"),
    (("adaptive", "bilinear"), ("none", "windowed"),
     "sampling mode.*PE variant")])
def test_a_tree_of_another_mode_or_variant_is_refused(tree, model, why):
    jcfg, _ = _model_configs(*tree)
    _, tcfg = _model_configs(*model)
    img, cam = _input(tree[0]), np.asarray([1.6], np.float32)
    variables = _random_variables(jcfg.build().init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=2)
    tmodel = tcfg.build()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with pytest.raises(ValueError, match=why):
        load_flax_variables(tmodel, variables["params"],
                            variables["batch_stats"])
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k      # nothing was loaded


def test_exact_nearest_and_compat_share_one_tree():
    jcfg, _ = _model_configs("adaptive", "bilinear")
    img, cam = _input("adaptive"), np.asarray([1.6], np.float32)
    variables = _random_variables(jcfg.build().init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=3)
    for sampling in ("nearest", "windowed_compat"):
        load_flax_variables(_model_configs("adaptive", sampling)[1].build(),
                            variables["params"], variables["batch_stats"])
