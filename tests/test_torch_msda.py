"""Windowed deformable sampling of the PyTorch port against the JAX package.

The port forms level-pixel positions with `windowed_positions` and samples
them with `msda` (its plain per-level gather on CPU tensors); the JAX side
is `msda_sample_windowed` through its CPU references, the XLA `tiled`
local-attention form and the `taps` enumeration. Cases: levels at several
ratios to the query grid, a coarse grid sampling a much finer level, and a
grid that is not a multiple of the TPU query tile. Then `MSDeformAttention`
and `HAHINeck` (hi_min_level 0 and 1) with weights carried over by
`state_dict_from_flax`. Seeded numpy inputs on both sides; tolerance
rtol 1e-4, atol 1e-5 (f32, sums in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models.hahi import HAHINeck as JaxHAHINeck
from gedepth_tpu.models.hahi import MSDeformAttention as JaxMSDA
from gedepth_tpu.ops.msda import (
    _axis_anchor_residual, msda_sample_windowed)
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models.hahi import HAHINeck, MSDeformAttention
from gedepth_tpu_torch.ops import msda as msda_ops

torch.set_num_threads(1)
R = 4


def _random_variables(init_fn, *args, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        name = names[-1]
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape)
        if name == "scale":
            return 1 + rng.normal(0, 0.1, s.shape)
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(s.shape[:-1]))
            if "sampling_offsets" in names:
                std *= 3   # offsets of a few level pixels, some past R
            return rng.normal(0, std, s.shape)
        if name == "level_embed":
            return rng.normal(0, 1.0, s.shape)
        return rng.normal(0, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


CASES = {
    # query grid, value levels
    "multi_ratio": ((8, 16), ((16, 32), (8, 16), (4, 8), (2, 4))),
    "coarse_grid_fine_level": ((3, 5), ((12, 20), (6, 10), (3, 5))),
    "not_a_tile_multiple": ((5, 13), ((10, 26), (5, 13))),
}


@pytest.mark.parametrize("impl", ["tiled", "taps"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_sampler_matches_jax(case, impl):
    query_hw, levels = CASES[case]
    rng = np.random.default_rng(0)
    B, h, d, P, L = 2, 2, 8, 3, len(levels)
    Nq = query_hw[0] * query_hw[1]
    values = [rng.standard_normal((B, H_, W_, h, d)).astype(np.float32)
              for (H_, W_) in levels]
    raw = rng.normal(0, 3.0, (B, Nq, h, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)

    off_px = R * jnp.tanh(jnp.asarray(raw) / R)
    want = np.asarray(msda_sample_windowed(
        [jnp.asarray(v) for v in values], off_px, jnp.asarray(w), query_hw,
        radius=R, remat=False, impl=impl,
        precision=jax.lax.Precision.HIGHEST))

    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, d) for v in values], axis=1))
    pos = msda_ops.windowed_positions(torch.from_numpy(raw), [query_hw],
                                      levels, R)
    got = msda_ops.msda(value, levels, pos, torch.from_numpy(w))
    assert got.shape == (B, Nq, h * d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_anchor_table_matches_jax():
    for nq, nv in ((11, 88), (44, 88), (176, 11), (5, 13), (38, 304)):
        a, r = msda_ops.axis_anchor_residual(nq, nv)
        ja, jr = _axis_anchor_residual(nq, nv)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(r, jr)


def test_plain_sampler_zero_padding():
    """Corners outside the level contribute zero (grid_sample 'zeros')."""
    value = torch.ones(1, 6, 1, 1)   # one 2x3 level of ones
    pos = torch.tensor([[-1.0, -1.0], [-0.5, 0.0], [1.0, 0.5],
                        [2.5, 1.0]]).view(1, 4, 1, 1, 1, 2)
    w = torch.ones(1, 4, 1, 1, 1)
    got = msda_ops.msda(value, [(2, 3)], pos, w).view(-1)
    np.testing.assert_allclose(got.numpy(), [0.0, 0.5, 1.0, 0.5])


def test_msdeform_attention_matches_flax():
    rng = np.random.default_rng(1)
    C, heads, P = 32, 2, 3
    levels = ((8, 16), (4, 8), (2, 4))
    query_shapes = levels[1:]
    B, Nv = 1, sum(a * b for a, b in levels)
    Nq = sum(a * b for a, b in query_shapes)
    value = rng.standard_normal((B, Nv, C)).astype(np.float32)
    query = value[:, Nv - Nq:].copy()
    qpos = rng.standard_normal((1, Nq, C)).astype(np.float32)

    jm = JaxMSDA(C, heads, len(levels), P, sampling="windowed",
                 window_radius=R, msda_remat=False)

    def apply(v, q, val, qp):
        return jm.apply(v, q, val, qp, None, levels, True,
                        query_shapes=query_shapes)

    def init(key, q, val, qp):
        return jm.init(key, q, val, qp, None, levels, True,
                       query_shapes=query_shapes)

    args = tuple(jnp.asarray(a) for a in (query, value, qpos))
    variables = _random_variables(init, *args, seed=2)
    want = np.asarray(jax.jit(apply)(variables, *args))

    tm = MSDeformAttention(C, heads, len(levels), P, R).eval()
    tm.load_state_dict(_strip(state_dict_from_flax(
        {"neck": {"self_attn": variables["params"]}}), "neck.self_attn."),
        strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, value, qpos)),
                 levels, query_shapes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hi_min_level", [0, 1])
def test_hahi_neck_matches_flax(hi_min_level):
    rng = np.random.default_rng(3)
    chans = (16, 24, 32, 40, 48)
    grids = ((32, 64), (16, 32), (8, 16), (4, 8), (2, 4))
    feats = [rng.standard_normal((1, h_, w_, c)).astype(np.float32)
             for (h_, w_), c in zip(grids, chans)]
    jm = JaxHAHINeck(in_channels=chans, out_channels=chans, embed_dim=32,
                     num_heads=2, num_points=3, sampling="windowed",
                     window_radius=R, hi_min_level=hi_min_level,
                     msda_remat=False)
    args = [jnp.asarray(f) for f in feats]
    variables = _random_variables(lambda k, x: jm.init(k, x), args, seed=4)
    want = jax.jit(lambda v, x: jm.apply(v, x))(variables, args)

    tm = HAHINeck(chans, chans, embed_dim=32, num_heads=2, num_points=3,
                  window_radius=R, hi_min_level=hi_min_level).eval()
    tm.load_state_dict(_strip(state_dict_from_flax(
        {"neck": variables["params"]}, {"neck": variables["batch_stats"]}),
        "neck."), strict=True)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w_), rtol=1e-4, atol=1e-5)


def _msda_inputs(case, seed=0, spread=3.0):
    query_hw, levels = CASES[case]
    rng = np.random.default_rng(seed)
    B, h, d, P, L = 2, 2, 8, 3, len(levels)
    Nq = query_hw[0] * query_hw[1]
    values = [rng.standard_normal((B, H_, W_, h, d)).astype(np.float32)
              for (H_, W_) in levels]
    raw = rng.normal(0, spread, (B, Nq, h, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    cot = rng.standard_normal((B, Nq, h * d)).astype(np.float32)
    return query_hw, levels, values, raw, w, cot


def _port_grads(sample, query_hw, levels, values, raw, w, cot):
    """Gradients of sum(sample(...) · cot) with respect to the value (levels
    stacked), the raw offsets and the weights, through the windowed rule."""
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, d) for v in values], axis=1)).requires_grad_()
    raw_t = torch.from_numpy(raw).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    pos = msda_ops.windowed_positions(raw_t, [query_hw], levels, R)
    (sample(value, levels, pos, w_t) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in (value, raw_t, w_t)]


def _jax_grads(sample_fn, values, raw, w, cot):
    """jax.grad of sum(sample_fn(levels, R·tanh(raw/R), w) · cot)."""
    def loss(vs, r, w_):
        out = sample_fn(list(vs), R * jnp.tanh(r / R), w_)
        return jnp.sum(out.reshape(cot.shape) * cot)

    gv, gr, gw = jax.grad(loss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(v) for v in values), jnp.asarray(raw),
        jnp.asarray(w))
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    gv = np.concatenate([np.asarray(g).reshape(B, -1, h, d) for g in gv],
                        axis=1)
    return [gv, np.asarray(gr), np.asarray(gw)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_sampler_grads_match_jax(case):
    """d_value, d_raw_offsets and d_weights of the port (autograd through
    `windowed_positions` and the plain sampler, and kernel C's plain twin)
    against jax.grad through R·tanh and the XLA tiled sampler."""
    query_hw, levels, values, raw, w, cot = _msda_inputs(case)
    want = _jax_grads(
        lambda vs, off, w_: msda_sample_windowed(
            vs, off, w_, query_hw, radius=R, remat=False, impl="tiled",
            precision=jax.lax.Precision.HIGHEST), values, raw, w, cot)
    got = _port_grads(msda_ops.msda, query_hw, levels, values, raw, w, cot)
    for g, w_, name in zip(got, want, ("value", "offsets", "weights")):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-5, err_msg=name)

    # the plain twin of kernel C, on the positions the rule forms
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, d) for v in values], axis=1))
    pos = msda_ops.windowed_positions(torch.from_numpy(raw), [query_hw],
                                      levels, R)
    d_value, d_pos, d_w = msda_ops.msda_backward_plain(
        value, levels, pos, torch.from_numpy(w), torch.from_numpy(cot))
    np.testing.assert_allclose(d_value.numpy(), want[0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), want[2], rtol=1e-4, atol=1e-5)
    dtanh = 1 - np.tanh(raw / R) ** 2       # d pos / d raw
    np.testing.assert_allclose(d_pos.numpy() * dtanh, want[1], rtol=1e-4,
                               atol=1e-5)


def test_windowed_sampler_grads_match_pallas_backward_interpret():
    """Against `msda_windowed_levels`, whose custom VJP runs the Pallas
    backward kernel `_kernel_bwd` (d_offsets, d_weights) in the TPU
    interpreter, at the shapes of tests/test_pallas_kernels.py (query grid
    16x40, levels 16x40 and 8x20, R = 4)."""
    from jax.experimental.pallas import tpu as pltpu
    from gedepth_tpu.ops.pallas.msda_windowed import msda_windowed_levels

    rng = np.random.default_rng(11)
    B, h, d, P = 1, 2, 8, 4
    query_hw, levels = (16, 40), ((16, 40), (8, 20))
    Nq = query_hw[0] * query_hw[1]
    values = [rng.standard_normal((B, H_, W_, h, d)).astype(np.float32)
              for (H_, W_) in levels]
    raw = rng.normal(0, 3.0, (B, Nq, h, len(levels), P, 2)).astype(
        np.float32)
    w = rng.uniform(0, 1, (B, Nq, h, len(levels), P)).astype(np.float32)
    cot = rng.standard_normal((B, Nq, h * d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(
            lambda vs, off, w_: msda_windowed_levels(
                tuple(vs), off, w_, query_hw, R, None, True),
            values, raw, w, cot)
    got = _port_grads(msda_ops.msda, query_hw, levels, values, raw, w, cot)
    for g, w_, name in zip(got, want, ("value", "offsets", "weights")):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-5, err_msg=name)


def test_msda_function_wiring(monkeypatch):
    """`MSDAFunction` (kernel B forward, kernel C backward) with both
    launches swapped for their plain versions: its gradients equal autograd
    through `msda_plain` (saved tensors, argument order, the None slot of
    the level shapes)."""
    query_hw, levels, values, raw, w, cot = _msda_inputs(
        "coarse_grid_fine_level", seed=5)
    monkeypatch.setattr(msda_ops, "_launch_forward", msda_ops.msda_plain)
    monkeypatch.setattr(msda_ops, "msda_backward",
                        msda_ops.msda_backward_plain)

    def through_function(value, shapes, pos, weights):
        return msda_ops.MSDAFunction.apply(value, shapes, pos, weights)

    got = _port_grads(through_function, query_hw, levels, values, raw, w,
                      cot)
    want = _port_grads(msda_ops.msda_plain, query_hw, levels, values, raw, w,
                       cot)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7)
