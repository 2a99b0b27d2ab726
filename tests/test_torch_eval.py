"""The PyTorch port's eval steps and metrics against the JAX package, on
the CPU (the `Evaluator` and the CLI are in tests/test_torch_evaluator.py).

Eval steps (`make_eval_step` at multi-scale ratios, `resize_pe_exact`,
`resize_img5_scaled`, `make_slide_eval_step`) against
`gedepth_tpu.train.steps`; the numpy metrics and crops against
`gedepth_tpu.core.metrics`; the torch device metrics against the numpy
ones.

Smoke widths, the exact (bilinear) neck, seeded numpy variables carried over
by `load_flax_variables`. Tolerances: depth maps rtol 1e-4, atol 1e-3 m;
resampled PE, compared as inverse depth, rtol 1e-5, atol 1e-8 per metre (an
ulp of the largest inverse a tap mixes in); numpy metrics rtol 1e-6 (the same float64
arithmetic); device metrics against numpy rtol 1e-5 (f32 sums over a few
hundred pixels).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.core import metrics as jmetrics
from gedepth_tpu.train import steps as jsteps
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import load_flax_variables
from gedepth_tpu_torch.core import metrics as tmetrics
from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
from gedepth_tpu_torch.train import steps as tsteps

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

H, W = 96, 192


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model on the same weights)."""
    over = dict(neck_sampling="bilinear")
    jmodel = dataclasses.replace(jax_get_config("smoke_synthetic").model,
                                 **over).build()
    variables = _random_variables(jmodel.init, jnp.zeros((1, H, W, 5)),
                                  jnp.ones((1,)), seed=5)
    tmodel = load_flax_variables(
        dataclasses.replace(get_config("smoke_synthetic").model,
                            **over).build(),
        variables["params"], variables["batch_stats"])
    return jmodel, variables, tmodel


def _batch(n=2, seed=1):
    """Normalised synthetic frames as the evaluator feeds them."""
    from gedepth_tpu_torch.data.transforms import build_test_pipeline

    ds = SyntheticGroundDataset(size=n, height=H, width=W, seed=seed)
    pipe = build_test_pipeline(get_config("smoke_synthetic").data)
    samples = [pipe(ds[i]) for i in range(n)]
    return (np.stack([s["img"] for s in samples]).astype(np.float32),
            np.stack([s["cam_height"] for s in samples]).astype(np.float32))


def _horizon_pe(h, w):
    """A raw PE with the horizon inside the frame: positive below, negative
    above, exactly-zero rows (as `sanitize_pe_raw` leaves a NaN row) and
    values at the ±1e6 clamp."""
    v = np.arange(h, dtype=np.float64)[:, None] - 0.31 * h
    u = np.arange(w, dtype=np.float64)[None, :] - w / 2
    with np.errstate(divide="ignore"):
        pe = 1.65 * 720.0 / (v + 0.002 * u)
    pe = np.clip(np.nan_to_num(pe, nan=0.0, posinf=1e6, neginf=-1e6),
                 -1e6, 1e6)
    row = int(0.31 * h)
    pe[row - 1:row + 2] = 0.0
    pe[row + 2, 40:60], pe[row - 2, 100:120] = 1e6, -1e6
    return pe.astype(np.float32)


def _assert_pe_close(got, want):
    """Zeros and signs equal; values compared as inverse depths, the space
    the resize interpolates in."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    nz = want != 0
    np.testing.assert_allclose(1.0 / got[nz], 1.0 / want[nz], rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("size", [(64, 128), (128, 256), (80, 200)])
def test_resize_pe_exact_matches_jax(size):
    pe = _horizon_pe(H, W)[None, ..., None]
    assert (pe == 0).any() and (pe < 0).any() and (np.abs(pe) == 1e6).any()
    want = jsteps.resize_pe_exact(jnp.asarray(pe), size)
    got = tsteps.resize_pe_exact(torch.from_numpy(pe), size)
    _assert_pe_close(got.numpy(), want)
    # zeros stay exact zeros, nothing passes the clamp
    assert got.abs().max() <= 1e6 and (got.abs() == 1e6).any()
    if size == (64, 128):
        assert (got == 0).any()


@pytest.mark.parametrize("channels", [5, 3])
def test_resize_img5_scaled_matches_jax(channels):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    pe = _horizon_pe(H, W)
    img[..., 4] = pe
    img[..., 3] = np.where((pe > 0) & (pe <= 200.0), pe / 200.0, 0.0)
    img = img[..., :channels]
    want = np.asarray(jsteps.resize_img5_scaled(jnp.asarray(img), (64, 128),
                                                200.0))
    got = tsteps.resize_img5_scaled(torch.from_numpy(img), (64, 128),
                                    200.0).numpy()
    assert got.shape == want.shape == (2, 64, 128, channels)
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=1e-5,
                               atol=1e-6)
    if channels == 5:
        _assert_pe_close(got[..., 4], want[..., 4])
        np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-5,
                                   atol=1e-6)
        assert (got[..., 3] == 0).any() and (got[..., 3] > 0).any()


def test_slide_positions_match_jax():
    for args in ((352, 352, 176), (1216, 704, 352), (96, 64, 32),
                 (100, 64, 48), (64, 96, 10)):
        assert tsteps.slide_positions(*args) == jsteps.slide_positions(*args)
    assert tsteps.snap32(352, 0.75) == 256 and tsteps.snap32(1216, 1.25) == 1536
    assert tsteps.snap32(40, 0.5) == 32


@pytest.mark.parametrize("ratio", [0.75, 1.25])
def test_eval_step_at_a_ratio_matches_jax(models, ratio):
    jmodel, variables, tmodel = models
    img, cam = _batch()
    want = np.asarray(jsteps.make_eval_step(jmodel, flip_tta=True,
                                            ratio=ratio)(
        variables["params"], variables["batch_stats"],
        {"img": jnp.asarray(img), "cam_height": jnp.asarray(cam)}))
    got = tsteps.make_eval_step(tmodel, flip_tta=True, ratio=ratio)(
        torch.from_numpy(img), torch.from_numpy(cam)).numpy()
    assert got.shape == want.shape == (2, H, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    plain = tsteps.make_eval_step(tmodel, flip_tta=True)(
        torch.from_numpy(img), torch.from_numpy(cam)).numpy()
    assert np.abs(got - plain).max() > 1e-2     # the ratio does something


def test_slide_eval_step_matches_jax(models):
    jmodel, variables, tmodel = models
    img, cam = _batch()
    tile, stride = (64, 128), (32, 48)     # 2 x 3 windows, the last flush
    want = np.asarray(jsteps.make_slide_eval_step(jmodel, tile, stride)(
        variables["params"], variables["batch_stats"],
        {"img": jnp.asarray(img), "cam_height": jnp.asarray(cam)}))
    got = tsteps.make_slide_eval_step(tmodel, tile, stride)(
        torch.from_numpy(img), torch.from_numpy(cam)).numpy()
    assert got.shape == want.shape == (2, H, W)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="stride"):
        tsteps.make_slide_eval_step(tmodel, (64, 128), (65, 128))
    with pytest.raises(ValueError, match="larger"):
        tsteps.make_slide_eval_step(tmodel, (128, 128), (64, 64))(
            torch.from_numpy(img), torch.from_numpy(cam))


def _depth_pair(rng, shape=(40, 64), sparse=0.7):
    gt = rng.uniform(0.5, 90.0, shape).astype(np.float32)
    gt[rng.random(shape) < sparse] = 0.0
    pred = np.clip(gt * rng.uniform(0.6, 1.6, shape)
                   + rng.normal(0, 1, shape), 1e-3, 80.0).astype(np.float32)
    return gt, pred


def test_numpy_metrics_match_the_jax_package():
    rng = np.random.default_rng(1)
    assert tmetrics.METRIC_NAMES == jmetrics.METRIC_NAMES
    rows_t, rows_j = [], []
    for _ in range(3):
        gt, pred = _depth_pair(rng)
        rows_t.append(tmetrics.masked_metrics(gt, pred))
        rows_j.append(jmetrics.masked_metrics(gt, pred))
        np.testing.assert_allclose(rows_t[-1], rows_j[-1], rtol=1e-6)
    empty = tmetrics.masked_metrics(np.zeros((4, 4), np.float32),
                                    np.ones((4, 4), np.float32))
    assert all(np.isnan(v) for v in empty)
    rows_t.append(empty), rows_j.append(empty)
    agg_t, agg_j = (tmetrics.aggregate_metrics(rows_t),
                    jmetrics.aggregate_metrics(rows_j))
    assert list(agg_t) == list(agg_j)
    np.testing.assert_allclose(list(agg_t.values()), list(agg_j.values()),
                               rtol=1e-6)
    # one valid pixel: the variance is 0 or rounds below it; silog NaN -> 0
    one = tmetrics.calculate_metrics(np.array([7.3], np.float32),
                                     np.array([9.1], np.float32))
    assert one[7] == 0 or np.isfinite(one[7])


@pytest.mark.parametrize("shape", [(352, 1216), (375, 1242), (96, 192)])
def test_eval_crops_match_the_jax_package(shape):
    rng = np.random.default_rng(2)
    gt = rng.uniform(0, 90, shape).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.garg_crop_mask(shape),
                                  jmetrics.garg_crop_mask(shape))
    np.testing.assert_array_equal(tmetrics.eigen_crop_mask(shape),
                                  jmetrics.eigen_crop_mask(shape))
    for garg, eigen in ((True, False), (False, True), (False, False)):
        np.testing.assert_array_equal(
            tmetrics.eval_crop_mask(gt, 1e-3, 80.0, garg, eigen),
            jmetrics.eval_crop_mask(gt, 1e-3, 80.0, garg, eigen))
    if shape[0] >= 352:
        np.testing.assert_array_equal(tmetrics.eval_kb_crop(gt),
                                      jmetrics.eval_kb_crop(gt))


def test_device_metrics_match_numpy_and_jax():
    rng = np.random.default_rng(3)
    pairs = [_depth_pair(rng) for _ in range(3)]
    pairs.append((np.zeros((40, 64), np.float32),
                  np.ones((40, 64), np.float32)))       # an empty mask
    gt = np.stack([p[0] for p in pairs])
    pred = np.stack([p[1] for p in pairs])
    mask = np.stack([tmetrics.eval_crop_mask(g, 1e-3, 80.0) for g in gt])
    got = tmetrics.batched_masked_metrics(
        torch.from_numpy(gt), torch.from_numpy(pred),
        torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 9) and got.dtype == np.float32
    want = np.array([tmetrics.calculate_metrics(g[m], p[m])
                     for g, p, m in zip(gt, pred, mask)], np.float64)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)
    assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
    jgot = np.asarray(jmetrics.batched_masked_metrics_jax(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask)))
    np.testing.assert_allclose(got[:3], jgot[:3], rtol=1e-5)
