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
    # the cross-attention's learned reference points keep the reference key
    sd = state_dict_from_flax({"neck": {"reference_points": {
        "kernel": dense, "bias": dense[0]}}})
    np.testing.assert_array_equal(
        sd["neck.reference_points.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(
        sd["neck.reference_points.bias"].numpy(), dense[0])
    with pytest.raises(KeyError):
        state_dict_from_flax({"neck": {"query_embed": {"kernel": dense}}})


def test_slope_gt_matches_jax():
    from gedepth_tpu.geometry import plane as jplane
    from gedepth_tpu_torch.geometry import plane as tplane

    rng = np.random.default_rng(4)
    pe = rng.uniform(-20, 120, (12, 20))
    gt = rng.uniform(0, 90, (12, 20))
    gt[rng.random(gt.shape) < 0.3] = 0.0
    want = jplane.slope_bin_gt(gt, pe, 1.65)
    got = tplane.slope_bin_gt(gt, pe, 1.65)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tplane.slope_gt_to_class(got),
                                  jplane.slope_gt_to_class(want))


def test_synthetic_dataset_matches_jax():
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset

    want, got = JaxDS(size=3, height=48, width=96), SyntheticGroundDataset(
        size=3, height=48, width=96)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


def test_train_loader_matches_jax():
    """The same batch for (seed, step) through the synthetic training
    pipeline (flip, crop, colour, normalise), across an epoch boundary, and
    the same stream from the prefetch thread."""
    import dataclasses

    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.data.loader import TrainLoader as JaxLoader
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS
    from gedepth_tpu.train.loop import build_train_pipeline as jax_pipeline
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset

    jcfg = jax_get_config("smoke_synthetic")
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data,
                                                 crop_size=(32, 64)))
    tdata = dataclasses.replace(get_config("smoke_synthetic").data,
                                crop_size=(32, 64))
    want = JaxLoader(JaxDS(size=3, height=48, width=96), jax_pipeline(jcfg),
                     2, seed=7)
    loader = TrainLoader(SyntheticGroundDataset(size=3, height=48, width=96),
                         build_train_pipeline(tdata), 2, seed=7)
    stream = iter(loader)
    try:
        for step in range(3):
            got, ref = loader.make_batch(step), want._make_batch(step)
            assert got["img"].shape == (2, 32, 64, 5)
            assert sorted(got) == sorted(ref)
            for key in got:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"{key} step {step}")
            streamed = next(stream)
            for key in got:
                np.testing.assert_array_equal(streamed[key], got[key])
    finally:
        stream.close()
