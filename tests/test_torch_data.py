"""Test-time pipeline, resize and converter of the PyTorch port against the
JAX package (numpy and torch on the CPU; resize tolerance rtol 1e-5,
atol 1e-5 in f32, the pipeline is exact)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gedepth_tpu_torch.convert import state_dict_from_flax, unstack_swin_params

torch.set_num_threads(1)


def test_kitti_test_pipeline_matches_jax():
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.eval.evaluator import build_test_pipeline as jax_build
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import build_test_pipeline
    from gedepth_tpu_torch.data.synthetic import synthetic_request
    from gedepth_tpu_torch.geometry.plane import clip_pe_for_input

    rgb, pe = synthetic_request(np.random.default_rng(0))
    assert rgb.shape == (375, 1242, 3) and np.isfinite(pe).all()
    img = np.concatenate([rgb, clip_pe_for_input(pe)[..., None],
                          pe[..., None]], axis=-1)
    name = "gedepth_adaptive_kitti_tpu"
    want = jax_build(jax_get_config(name).data)(
        {"img": img.copy()}, np.random.default_rng(0))["img"]
    got = build_test_pipeline(get_config(name).data)({"img": img.copy()})[
        "img"]
    assert got.shape == (352, 1216, 5)
    np.testing.assert_array_equal(got, want)


def test_synthetic_camera_matches_jax():
    from gedepth_tpu.data.synthetic import _toy_projection
    from gedepth_tpu_torch.data.synthetic import toy_projection

    np.testing.assert_array_equal(toy_projection(375, 1242),
                                  _toy_projection(375, 1242))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(7, 13), (44, 152), (3, 5)])
def test_resize_matches_jax(align_corners, size):
    from gedepth_tpu.ops.resize import resize_bilinear as jax_resize
    from gedepth_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(1).standard_normal((2, 11, 38, 3)).astype(
        np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), size, align_corners))
    got = resize_bilinear(torch.from_numpy(x), size, align_corners)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_converter_layouts_and_unstacking():
    rng = np.random.default_rng(2)
    conv = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)   # HWIO
    dense = rng.standard_normal((5, 6)).astype(np.float32)        # (in, out)
    stacked = rng.standard_normal((2, 6)).astype(np.float32)      # 2 pairs
    params = {
        "backbone": {
            "stage0_pairs": {"block0": {"norm1": {"scale": stacked}},
                             "block1": {"norm1": {"scale": stacked + 1}}},
            "conv_stem": {"Conv_0": {"kernel": conv},
                          "BatchNorm_0": {"scale": np.ones(8, np.float32)}},
        },
        "decode_head": {"up1": {"convA": {"Conv_0": {"kernel": conv}}}},
        "neck": {"cross_attn": {"value_proj": {"kernel": dense}}},
    }
    stats = {"backbone": {"conv_stem": {"BatchNorm_0": {
        "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}}}
    sd = state_dict_from_flax(params, stats)
    np.testing.assert_array_equal(sd["backbone.conv1.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["decode_head.conv_list.1.convA.conv.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["neck.multi_att.value_proj.weight"].numpy(), dense.T)
    for p in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                sd[f"backbone.stages.0.blocks.{2 * p + j}.norm1.weight"]
                .numpy(), stacked[p] + j)
    assert sd["backbone.bn1.running_var"].shape == (8,)
    assert sd["backbone.bn1.num_batches_tracked"].item() == 0
    # the layout rule of gedepth_tpu.models.swin.unstack_swin_params
    from gedepth_tpu.models.swin import unstack_swin_params as jax_unstack
    want = jax_unstack(params["backbone"])
    got = unstack_swin_params(params["backbone"])
    assert sorted(got) == sorted(want)
    with pytest.raises(KeyError):
        state_dict_from_flax({"neck": {"reference_points": {
            "kernel": dense}}})
