"""The exact, nearest and compat sampling modes of the PyTorch port against
the JAX package, on the CPU.

The port forms level-pixel positions with the rules of
`gedepth_tpu_torch.ops.msda` (`exact_positions`, `nearest_positions`,
`compat_positions`) and samples them with `msda` (its plain per-level gather
on CPU tensors). The JAX side forms normalised locations as
`gedepth_tpu.models.hahi` does and samples with `msda_sample`
(impl='per_level', bilinear and nearest) and, for compat,
`msda_sample_windowed` (impl='tiled', HIGHEST precision). Then
`MSDeformAttention` and `HAHINeck` per mode (hi_min_level 0 and 1) with
weights carried over by `state_dict_from_flax`, `compat_clamp_mass` and
`compat_delta_px`, and the neck's gradients against `jax.grad`.

Seeded numpy inputs on both sides, f32. Tolerances: sampled outputs rtol
1e-4, atol 1e-5 (sums in another order); the nearest rule's tap choice
exact; `compat_delta_px` and `compat_clamp_mass` rtol 1e-5; gradients rtol
1e-3 plus atol 1e-4·max|g| per tensor (the backward sums thousands of
products of both signs in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import hahi as jhahi
from gedepth_tpu.ops.msda import msda_sample, msda_sample_windowed
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models import hahi as thahi
from gedepth_tpu_torch.ops import msda as msda_ops

from test_torch_msda import _random_variables, _strip

torch.set_num_threads(1)

LEVELS = ((8, 16), (4, 8), (2, 4))


def _value_levels(rng, levels, B=2, h=2, d=8):
    values = [rng.standard_normal((B, H_, W_, h, d)).astype(np.float32)
              for (H_, W_) in levels]
    stacked = np.concatenate([v.reshape(B, -1, h, d) for v in values], axis=1)
    return values, torch.from_numpy(stacked)


def _jax_locations(ref, off, levels):
    """ref + off / (W, H), as `gedepth_tpu.models.hahi.MSDeformAttention`
    forms them."""
    normalizer = np.array([[w_, h_] for (h_, w_) in levels], np.float32)
    ref = jnp.asarray(ref)
    ref = (ref[None, :, None, :, None, :] if ref.ndim == 3
           else ref[:, :, None, :, None, :])
    return ref + jnp.asarray(off) / jnp.asarray(normalizer)[
        None, None, None, :, None, :]


def _rule_inputs(rng, query_shapes, levels, B=2, h=2, P=3, learned=False,
                 spread=3.0):
    Nq, L = sum(a * b for a, b in query_shapes), len(levels)
    off = rng.normal(0, spread, (B, Nq, h, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    if learned:    # anywhere in the image, also at its very borders
        ref = rng.uniform(0, 1, (B, Nq, L, 2)).astype(np.float32)
        ref[:, ::7], ref[:, 3::7] = 0.0, 1.0
    else:
        ref = np.ascontiguousarray(np.tile(
            msda_ops.grid_centers(query_shapes)[:, None, :], (1, L, 1)))
    return ref, off, w


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_exact_and_nearest_rules_match_jax(mode, learned):
    rng = np.random.default_rng(0)
    query_shapes = ((8, 16),) if learned else LEVELS[1:]
    values, value = _value_levels(rng, LEVELS)
    ref, off, w = _rule_inputs(rng, query_shapes, LEVELS, learned=learned)
    off[:, 1::5] *= 30.0      # some samples far outside every level
    want = np.asarray(msda_sample(
        [jnp.asarray(v) for v in values], _jax_locations(ref, off, LEVELS),
        jnp.asarray(w), remat=False, sampling=mode, impl="per_level"))

    rule = (msda_ops.exact_positions if mode == "bilinear"
            else msda_ops.nearest_positions)
    pos = rule(torch.from_numpy(ref), torch.from_numpy(off), LEVELS)
    got = msda_ops.msda(value, LEVELS, pos, torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_nearest_rule_floors_the_number_jax_floors():
    """Offsets of n + 0.5 pixels from a grid centre put loc·size on or just
    beside an integer: the tap depends on the f32 order ref + off/size,
    then ·size. The port's taps equal JAX's everywhere, and a rule that
    rounds elsewhere (centre·size + off) picks other taps on these inputs,
    so the comparison can fail."""
    rng = np.random.default_rng(1)
    levels, query_shapes = ((11, 38), (6, 19)), ((11, 38),)
    B, h, P, L = 1, 2, 8, 2
    Nq = 11 * 38
    off = (rng.integers(-6, 7, (B, Nq, h, L, P, 2)) + 0.5).astype(np.float32)
    ref = np.ascontiguousarray(np.tile(
        msda_ops.grid_centers(query_shapes)[:, None, :], (1, L, 1)))
    locs = _jax_locations(ref, off, levels)
    size = np.array([[w_, h_] for (h_, w_) in levels], np.float32)
    want = np.asarray(jnp.floor(
        locs * jnp.asarray(size)[None, None, None, :, None, :]))
    got = msda_ops.nearest_positions(torch.from_numpy(ref),
                                     torch.from_numpy(off), levels).numpy()
    np.testing.assert_array_equal(got, want)
    other = np.floor(ref[None, :, None, :, None, :]
                     * size[None, None, None, :, None, :] + off)
    assert (other != want).mean() > 0.01

    values, value = _value_levels(rng, levels, B=B, h=h)
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    out_want = np.asarray(msda_sample(
        [jnp.asarray(v) for v in values], locs, jnp.asarray(w), remat=False,
        sampling="nearest", impl="per_level"))
    out = msda_ops.msda(value, levels, torch.from_numpy(got),
                        torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), out_want, rtol=1e-5, atol=1e-6)


def test_nearest_rule_has_zero_gradient_to_offsets():
    rng = np.random.default_rng(2)
    _, value = _value_levels(rng, LEVELS)
    ref, off, w = _rule_inputs(rng, LEVELS[1:], LEVELS)
    off_t = torch.from_numpy(off).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    pos = msda_ops.nearest_positions(torch.from_numpy(ref), off_t, LEVELS)
    msda_ops.msda(value, LEVELS, pos, w_t).sum().backward()
    assert off_t.grad is not None and not off_t.grad.any()
    assert w_t.grad.abs().sum() > 0


@pytest.mark.parametrize("radius", [4, 6])
def test_compat_rule_matches_jax(radius):
    """Learned reference points anywhere in the image: most displacements
    exceed R and are clamped to the window's edge."""
    rng = np.random.default_rng(3)
    query_hw = (8, 16)
    values, value = _value_levels(rng, LEVELS)
    ref, off, w = _rule_inputs(rng, (query_hw,), LEVELS, learned=True)
    ref[:, ::2] = np.tile(msda_ops.grid_centers((query_hw,))[::2, None, :],
                          (1, len(LEVELS), 1))    # half of them unclamped
    delta = jhahi.compat_delta_px(jnp.asarray(ref), jnp.asarray(off),
                                  (query_hw,), LEVELS)
    want = np.asarray(msda_sample_windowed(
        [jnp.asarray(v) for v in values],
        jnp.clip(delta, -float(radius), float(radius)), jnp.asarray(w),
        query_hw, radius=radius, remat=False, impl="tiled",
        precision=jax.lax.Precision.HIGHEST))

    pos, got_delta = msda_ops.compat_positions(
        torch.from_numpy(ref), torch.from_numpy(off), (query_hw,), LEVELS,
        radius)
    np.testing.assert_allclose(got_delta.numpy(), np.asarray(delta),
                               rtol=1e-5, atol=1e-6)
    share = (np.abs(np.asarray(delta)) > radius).any(-1).mean()
    assert 0.2 < share < 0.8
    got = msda_ops.msda(value, LEVELS, pos, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the hint changes nothing
    assert torch.equal(got, msda_ops.msda(value, LEVELS, pos,
                                          torch.from_numpy(w), (query_hw,),
                                          radius))


def test_compat_delta_unclamped_reproduces_the_exact_positions():
    rng = np.random.default_rng(4)
    query_shapes = LEVELS[1:]
    ref, off, _ = _rule_inputs(rng, query_shapes, LEVELS, learned=True)
    ref_t, off_t = torch.from_numpy(ref), torch.from_numpy(off)
    delta = thahi.compat_delta_px(ref_t, off_t, query_shapes, LEVELS)
    pos = msda_ops.anchored_positions(delta, query_shapes, LEVELS)
    torch.testing.assert_close(
        pos, msda_ops.exact_positions(ref_t, off_t, LEVELS), rtol=0,
        atol=2e-5)


def test_center_reference_points_match_jax():
    for shapes in (LEVELS, ((11, 38), (6, 19), (3, 10))):
        np.testing.assert_array_equal(
            msda_ops.center_reference_points(shapes).numpy(),
            jhahi._center_reference_points(shapes))
        np.testing.assert_array_equal(msda_ops.grid_centers(shapes),
                                      jhahi._grid_centers(shapes))


def _attention_pair(mode, radius, seed):
    """A JAX and a port `MSDeformAttention` of one mode on the same weights
    and inputs; returns (jax apply, port module, inputs, variables)."""
    rng = np.random.default_rng(seed)
    C, heads, P = 32, 2, 3
    query_shapes = LEVELS[1:]
    B, Nv = 2, sum(a * b for a, b in LEVELS)
    Nq = sum(a * b for a, b in query_shapes)
    value = rng.standard_normal((B, Nv, C)).astype(np.float32)
    query = value[:, Nv - Nq:].copy()
    qpos = rng.standard_normal((1, Nq, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (1, Nq, len(LEVELS), 2)).astype(np.float32)

    jm = jhahi.MSDeformAttention(C, heads, len(LEVELS), P, sampling=mode,
                                 window_radius=radius, msda_remat=False)

    def apply(v, q, val, qp, r):
        return jm.apply(v, q, val, qp, jnp.broadcast_to(r, (B,) + r.shape[1:]),
                        LEVELS, True, query_shapes=query_shapes,
                        mutable=["intermediates"])

    def init(key, q, val, qp, r):
        return jm.init(key, q, val, qp, jnp.broadcast_to(
            r, (B,) + r.shape[1:]), LEVELS, True, query_shapes=query_shapes)

    args = tuple(jnp.asarray(a) for a in (query, value, qpos, ref))
    variables = _random_variables(init, *args, seed=seed + 1)
    variables = {"params": variables["params"]}
    tm = thahi.MSDeformAttention(C, heads, len(LEVELS), P, radius,
                                 sampling=mode).eval()
    tm.load_state_dict(_strip(state_dict_from_flax(
        {"neck": {"self_attn": variables["params"]}}), "neck.self_attn."),
        strict=True)
    return jax.jit(apply), tm, (query, value, qpos, ref), variables


@pytest.mark.parametrize("mode,radius", [
    ("bilinear", 4), ("nearest", 4), ("windowed_compat", 4),
    ("windowed_compat", 6)])
def test_msdeform_attention_modes_match_flax(mode, radius):
    apply, tm, (query, value, qpos, ref), variables = _attention_pair(
        mode, radius, seed=5)
    want, state = apply(variables, *(jnp.asarray(a) for a in
                                     (query, value, qpos, ref)))
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(value),
                 torch.from_numpy(qpos), LEVELS, LEVELS[1:],
                 torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    if mode == "windowed_compat":
        mass = float(state["intermediates"]["compat_clamp_mass"][0])
        assert 0.05 < mass < 0.95
        np.testing.assert_allclose(tm.compat_clamp_mass.item(), mass,
                                   rtol=1e-5)
    else:
        assert tm.compat_clamp_mass is None


def test_msdeform_attention_needs_reference_points_outside_windowed():
    _, tm, (query, value, qpos, _), _ = _attention_pair("bilinear", 4, seed=6)
    with pytest.raises(ValueError, match="reference_points"):
        tm(torch.from_numpy(query), torch.from_numpy(value),
           torch.from_numpy(qpos), LEVELS, LEVELS[1:])
    with pytest.raises(ValueError, match="sampling"):
        thahi.MSDeformAttention(sampling="bicubic")


def test_offset_bias_scaled_only_in_windowed_mode():
    from gedepth_tpu_torch.models.layers import init_weights

    for mode, scale in (("bilinear", 1.0), ("nearest", 1.0),
                        ("windowed_compat", 1.0), ("windowed", 6 / 8)):
        m = thahi.MSDeformAttention(32, 8, 4, 8, window_radius=6,
                                    sampling=mode)
        init_weights(m, torch.Generator().manual_seed(0))
        want = jhahi._msda_offset_bias_init(8, 4, 8, scale=scale)(
            None, (8 * 4 * 8 * 2,))
        np.testing.assert_array_equal(m.sampling_offsets.bias.detach().numpy(),
                                      np.asarray(want))


NECK_CHANS = (16, 24, 32, 40, 48)
NECK_GRIDS = ((32, 64), (16, 32), (8, 16), (4, 8), (2, 4))


def _neck_pair(mode, hi_min_level, seed, radius=4, batch=1):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((batch, h_, w_, c)).astype(np.float32)
             for (h_, w_), c in zip(NECK_GRIDS, NECK_CHANS)]
    jm = jhahi.HAHINeck(in_channels=NECK_CHANS, out_channels=NECK_CHANS,
                        embed_dim=32, num_heads=2, num_points=3,
                        sampling=mode, window_radius=radius,
                        hi_min_level=hi_min_level, msda_remat=False)
    args = [jnp.asarray(f) for f in feats]
    variables = _random_variables(lambda k, x: jm.init(k, x), args,
                                  seed=seed + 1)
    tm = thahi.HAHINeck(NECK_CHANS, NECK_CHANS, embed_dim=32, num_heads=2,
                        num_points=3, sampling=mode, window_radius=radius,
                        hi_min_level=hi_min_level).eval()
    tm.load_state_dict(_strip(state_dict_from_flax(
        {"neck": variables["params"]}, {"neck": variables["batch_stats"]}),
        "neck."), strict=True)
    return jm, tm, feats, variables


@pytest.mark.parametrize("hi_min_level", [0, 1])
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "windowed_compat"])
def test_hahi_neck_modes_match_flax(mode, hi_min_level):
    """The learned cross-attention reference points, the batch-1 query_pos
    broadcast over a batch of 2, and the self-attention's grid-centre
    reference points sliced under hi_min_level."""
    jm, tm, feats, variables = _neck_pair(mode, hi_min_level, seed=7,
                                          batch=2)
    assert "reference_points" in variables["params"]
    want, state = jax.jit(lambda v, x: jm.apply(
        v, x, mutable=["intermediates"]))(variables,
                                          [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w_), rtol=1e-4, atol=1e-5)
    if mode == "windowed_compat":
        for jname, tmod in (("self_attn", tm.self_attn),
                            ("cross_attn", tm.multi_att)):
            mass = float(state["intermediates"][jname]["compat_clamp_mass"][0])
            np.testing.assert_allclose(tmod.compat_clamp_mass.item(), mass,
                                       rtol=1e-5, atol=1e-7)
        assert tm.multi_att.compat_clamp_mass.item() > 0.05


def test_windowed_neck_has_no_reference_points_layer():
    assert not hasattr(thahi.HAHINeck(NECK_CHANS, NECK_CHANS, embed_dim=32,
                                      num_heads=2, num_points=3,
                                      sampling="windowed"),
                       "reference_points")
    _, tm, _, _ = _neck_pair("bilinear", 0, seed=8)
    assert tuple(tm.reference_points.weight.shape) == (2, 32)


@pytest.mark.parametrize("mode", ["bilinear", "windowed_compat"])
def test_hahi_neck_gradients_match_jax(mode):
    """d(Σ outputs·cotangents) with respect to every parameter and every
    input feature map, autograd through the position rule and the plain
    sampler against jax.grad through the JAX neck."""
    jm, tm, feats, variables = _neck_pair(mode, 0, seed=9)
    rng = np.random.default_rng(10)
    cots = [rng.standard_normal(f.shape).astype(np.float32) for f in feats]

    def loss(params, xs):
        outs = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, xs)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(outs, cots))

    g_params, g_feats = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], [jnp.asarray(f) for f in feats])
    want = _strip(state_dict_from_flax({"neck": jax.device_get(g_params)}),
                  "neck.")

    xs = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_()
          for f in feats]
    outs = tm(xs)
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cots)).backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)

    def check(g, w_, name):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-3,
                                   atol=1e-4 * np.abs(w_).max(),
                                   err_msg=name)

    for name, w_ in want.items():
        check(got[name], w_.numpy(), name)
    assert got["reference_points.weight"].abs().sum() > 0
    assert got["multi_att.sampling_offsets.weight"].abs().sum() > 0
    for x, w_, i in zip(xs, g_feats, range(len(xs))):
        check(x.grad.permute(0, 2, 3, 1), w_, f"input {i}")
