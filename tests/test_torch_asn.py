"""The port's ASN head and its functions (`models.asn`; the experiment
heads are tests/test_torch_experiment_heads.py's) against the JAX
package's, on the CPU, on carried weights
(`convert.from_jax.load_flax_variables`, and back through
`flax_variables_from_state_dict`).

Tolerances: f32 on both sides at rtol 1e-4, atol 1e-5 (of each output's
largest magnitude where it is not O(1)), as elsewhere in the port. The
adaptive normals are held in float64 on both sides (the JAX function casts
to f32 inside; the test runs it under `jax.enable_x64` with that cast
pointed at float64, and the resize's interpolation weights made in
float64): at the 1-pixel border, zero-padded taps make
near-degenerate triangles whose normals nearly cancel in the softmax mix,
and the final normalisation amplifies f32 rounding there (the JAX
package's own torch oracle test allows 2e-2 at the border, 1e-5 inside),
so f32 is compared inside the border only. `select_triangles` is equal
for seeds 0-3.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import asn as jax_asn
from gedepth_tpu_torch.convert.from_jax import (
    flax_variables_from_state_dict, load_flax_variables)
from gedepth_tpu_torch.models import asn

torch.set_num_threads(1)

UP = (8, 12, 16)
RTOL, ATOL = 1e-4, 1e-5


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL, scaled=True):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0) if scaled else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _variables(module, *args, seed=0, **kw):
    """Seeded flax variables, BatchNorm statistics drawn away from 0/1."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    return {"params": variables["params"], **({"batch_stats": stats}
                                              if stats else {})}


def _carry(port, variables):
    """Load the flax variables into the port's module, and check that the
    state_dict goes back to the same trees."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    load_flax_variables(port, params, stats)
    back_p, back_s = flax_variables_from_state_dict(port.state_dict())
    for want, got in ((params, back_p), (stats, back_s)):
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert set(map(str, flat_w)) == set(map(str, flat_g))
        for k, v in flat_w.items():
            np.testing.assert_array_equal(
                flat_g[[g for g in flat_g if str(g) == str(k)][0]],
                np.asarray(v))
    return port


def _pyramid(seed=0, batch=2, size=(16, 24)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, size[0] >> i, size[1] >> i, c))
            .astype(np.float32) for i, c in enumerate(UP)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_triangles_equal(seed):
    for k, n in ((3, 40), (5, 60)):
        got = asn.select_triangles(k, n, np.random.default_rng(seed))
        want = jax_asn.select_triangles(k, n, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_unfold_and_guidance_kernels_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    for k, d in ((3, 1), (5, 1), (3, 2)):
        _close(asn.unfold_patches(_t(x), k, d),
               jax_asn.unfold_patches(jnp.asarray(x), k, d), 0, 0)
        _close(asn._border_mask(7, 9, k, d, torch.float32),
               jax_asn._border_mask(7, 9, k, d, jnp.float32), 0, 0)
        g = x[..., :3] * 0.5
        _close(asn.pa_gaussian_kernel(_t(g), k, d),
               jax_asn.pa_gaussian_kernel(jnp.asarray(g), k, d))
        _close(asn.asn_guide_weight(_t(g), k, d),
               jax_asn.asn_guide_weight(jnp.asarray(g), k, d))


def _normals_inputs(seed=3, B=2, H=10, W=12):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 8.0, (B, H, W)).astype(np.float32)
    depth[0, :2, :3] = 0.0          # holes
    depth[1, 5, 5] = 50.0           # past depth_max
    K = np.array([[[60.0, 0, 6.0], [0, 60.0, 5.0], [0, 0, 1.0]]] * B,
                 np.float32)
    guide = rng.uniform(0.2, 2.0, (B, H, W, 9)).astype(np.float32)
    return depth, K, guide


class _Jnp64:
    """jax.numpy with float32 pointing at float64: the JAX function's f32
    cast, run in float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _Np64:
    """numpy with float32 pointing at float64: the JAX resize's
    interpolation weights, made in float64."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


CASES = [(True, True, True), (True, False, False), (False, True, False)]


@pytest.mark.parametrize("if_area,if_pa,with_guide", CASES)
def test_adaptive_normals_match_jax(if_area, if_pa, with_guide,
                                    monkeypatch):
    depth, K, guide = _normals_inputs()
    tri, areas = asn.select_triangles(3, 40, np.random.default_rng(7))
    g = guide if with_guide else None
    kw = dict(k_size=3, if_area=if_area, if_pa=if_pa)
    # f32 inside the 1-pixel border
    got = asn.adaptive_depth_to_normals(
        _t(depth), _t(K), tri, areas, None if g is None else _t(g), **kw)
    want = jax_asn.adaptive_depth_to_normals(
        jnp.asarray(depth), jnp.asarray(K), tri, areas,
        None if g is None else jnp.asarray(g), **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 10, 12, 3)
    _close(got[:, 1:-1, 1:-1], np.asarray(want)[:, 1:-1, 1:-1])
    # float64 everywhere
    monkeypatch.setattr(jax_asn, "jnp", _Jnp64())
    with jax.enable_x64(True):
        want64 = np.asarray(jax_asn.adaptive_depth_to_normals(
            jnp.asarray(depth, jnp.float64), jnp.asarray(K, jnp.float64),
            tri, areas.astype(np.float64),
            None if g is None else jnp.asarray(g, jnp.float64), **kw))
    assert want64.dtype == np.float64
    got64 = asn.adaptive_depth_to_normals(
        _t(depth, torch.float64), _t(K, torch.float64), tri, areas,
        None if g is None else _t(g, torch.float64), **kw)
    assert got64.dtype == torch.float64
    _close(got64, want64, rtol=1e-9, atol=1e-11)


def test_depth_normal_conversion_matches_jax(monkeypatch):
    depth, K, _ = _normals_inputs(seed=4)
    guidance = np.random.default_rng(5).uniform(
        0, 1, depth.shape + (1,)).astype(np.float32)
    tri, areas = asn.select_triangles(3, 40, np.random.default_rng(0))
    monkeypatch.setattr(jax_asn, "jnp", _Jnp64())
    with jax.enable_x64(True):
        want = jax_asn.depth_normal_conversion(
            jnp.asarray(depth, jnp.float64), jnp.asarray(K, jnp.float64),
            jnp.asarray(guidance, jnp.float64), tri,
            areas.astype(np.float64))
    got = asn.depth_normal_conversion(
        _t(depth, torch.float64), _t(K, torch.float64),
        _t(guidance, torch.float64), tri, areas)
    _close(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("train", [False, True])
def test_asn_seg_head_matches_jax(train):
    """Eval mode on the carried statistics; train mode on the batch's, the
    running statistics updated as flax updates them."""
    x = np.random.default_rng(9).standard_normal((2, 8, 10, 16)).astype(
        np.float32)
    ref = jax_asn.ASNSegHead(mid_channels=16, scale_factor=4.0)
    variables = _variables(ref, jnp.asarray(x))
    port = _carry(asn.ASNSegHead(16, scale_factor=4.0), variables)
    port.train(train)
    got = port(_t(x))["disparity"]
    if train:
        want, upd = ref.apply(variables, jnp.asarray(x), True,
                              mutable=["batch_stats"])
        _, stats = flax_variables_from_state_dict(port.state_dict())
        for i in range(3):
            for k in ("mean", "var"):
                _close(stats[f"bn{i}"][k],
                       upd["batch_stats"][f"bn{i}"][k])
    else:
        want = ref.apply(variables, jnp.asarray(x))
    assert got.shape == (2, 32, 40, 1)
    _close(got, want["disparity"])


def _v2_inputs(seed=10, B=2, H=6, W=8, C=16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, H, W, C)).astype(np.float32)
    K = np.array([[[80.0, 0, 32.0], [0, 80.0, 24.0], [0, 0, 1.0]]] * B,
                 np.float32)
    return feats, K


@pytest.mark.parametrize("train", [False, True])
def test_asn_depth_head_v2_matches_jax(train, monkeypatch):
    """disp, depth and guidance in f32; the normals in f32 inside the
    border and in float64 everywhere; the loss dict in f32 on the JAX
    outputs."""
    feats, K = _v2_inputs()
    ref = jax_asn.ASNDepthHeadV2(input_features_dim=16, sample_num=40)
    variables = _variables(ref, jnp.asarray(feats), jnp.asarray(K))
    port = _carry(asn.ASNDepthHeadV2(input_features_dim=16), variables)
    port.train(train)
    np.testing.assert_array_equal(port.triplets, jax_asn.select_triangles(
        3, 40, np.random.default_rng(0))[0])
    got = port(_t(feats), _t(K))
    if train:
        want, _ = ref.apply(variables, jnp.asarray(feats), jnp.asarray(K),
                            True, mutable=["batch_stats"])
    else:
        want = ref.apply(variables, jnp.asarray(feats), jnp.asarray(K))
    assert sorted(got) == sorted(want) == ["depth", "disp", "guidance",
                                           "normals"]
    for key in ("disp", "depth", "guidance"):
        assert got[key].shape == (2, 48, 64, 1)
        _close(got[key], want[key])
    _close(got["normals"][:, 1:-1, 1:-1],
           np.asarray(want["normals"])[:, 1:-1, 1:-1], atol=1e-4)
    assert "normals" not in port(_t(feats))

    rng = np.random.default_rng(11)
    depth_gt = rng.uniform(0.0, 9.0, (2, 48, 64)).astype(np.float32)
    rgb = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    sn = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    out_t = {k: _t(v) for k, v in want.items()}
    got_l = asn.asn_losses(out_t, _t(depth_gt), _t(rgb), _t(sn))
    want_l = jax_asn.asn_losses(want, jnp.asarray(depth_gt),
                                jnp.asarray(rgb), jnp.asarray(sn))
    assert sorted(got_l) == sorted(want_l) == [
        "smooth_loss", "supvised_loss", "surface_norm_loss"]
    for k in want_l:
        _close(got_l[k], want_l[k], rtol=1e-5, atol=0, scaled=False)

    # float64: the whole head, normals to the border
    import gedepth_tpu.ops.resize as jax_resize

    monkeypatch.setattr(jax_asn, "jnp", _Jnp64())
    monkeypatch.setattr(jax_resize, "np", _Np64())
    jax_resize._linear_weights.cache_clear()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        args = (jnp.asarray(feats, jnp.float64), jnp.asarray(K, jnp.float64))
        if train:
            want64, _ = ref.apply(v64, *args, True, mutable=["batch_stats"])
        else:
            want64 = ref.apply(v64, *args)
        want64 = {k: np.asarray(v) for k, v in want64.items()}
    jax_resize._linear_weights.cache_clear()
    port64 = port.double()
    got64 = port64(_t(feats, torch.float64), _t(K, torch.float64))
    for key in want64:
        assert got64[key].dtype == torch.float64
        _close(got64[key], want64[key], rtol=1e-9, atol=1e-11)
