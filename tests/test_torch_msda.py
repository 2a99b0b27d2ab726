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
from torch.utils._python_dispatch import TorchDispatchMode
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

    tm = MSDeformAttention(C, heads, len(levels), P, R,
                           sampling="windowed").eval()
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
                  sampling="windowed", window_radius=R,
                  hi_min_level=hi_min_level).eval()
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


class _OpCalls(TorchDispatchMode):
    """Records (op name, query grids, radius) of every call of the port's
    MSDA ops below autograd."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "gedepth_torch":
            self.calls.append((func.name(), list(args[-2]), args[-1]))
        return func(*args, **(kwargs or {}))


def test_msda_function_wiring():
    """`msda_op` (kernel B's op, with kernel C's op `msda_backward_op` as
    its registered backward) on CPU tensors, where both ops run the plain
    versions in place of the launches: its gradients equal autograd through
    `msda_plain` (saved tensors, argument order, the None slots of the level
    shapes and the window), and the window reaches both ops."""
    query_hw, levels, values, raw, w, cot = _msda_inputs(
        "coarse_grid_fine_level", seed=5)
    flat_levels = [v for hw in levels for v in hw]
    want = _port_grads(msda_ops.msda_plain, query_hw, levels, values, raw, w,
                       cot)
    for grids, radius in ((list(query_hw), float(R)), ([], None)):
        def through_op(value, shapes, pos, weights):
            return msda_ops.msda_op(value, flat_levels, pos, weights, grids,
                                    radius)

        with _OpCalls() as calls:
            got = _port_grads(through_op, query_hw, levels, values, raw, w,
                              cot)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7)
        assert calls.calls == [("gedepth_torch::msda", grids, radius),
                               ("gedepth_torch::msda_backward", grids,
                                radius)]

# --- the tile plan of kernels B and C (host side; the kernels run on the card)

SERVE_LEVELS = ((88, 304), (44, 152), (22, 76), (11, 38))
TRAIN_LEVELS = ((88, 176), (44, 88), (22, 44), (11, 22))
PLAN_CASES = {
    # query grids, value levels
    "serve_cross": (((176, 608),), SERVE_LEVELS),
    "serve_self": (SERVE_LEVELS, SERVE_LEVELS),
    "serve_self_hi1": (SERVE_LEVELS[1:], SERVE_LEVELS),
    "train_cross": (((176, 352),), TRAIN_LEVELS),
    "train_self_hi1": (TRAIN_LEVELS[1:], TRAIN_LEVELS),
    "ragged": (((5, 13), (3, 5)), ((10, 26), (5, 13), (1, 1))),
}


def _plan(case, head_dim=64, radius=float(R), stage_bytes=None):
    grids, levels = PLAN_CASES[case]
    _, lanes = msda_ops.channel_lanes(head_dim)
    return grids, levels, msda_ops.tile_plan(
        grids, levels, radius, head_dim,
        msda_ops.stage_budget(head_dim, lanes) if stage_bytes is None
        else stage_bytes)


def _plan_tiles(plan, n_levels):
    """(q_start, Wq, y0, x0, th, tw, rects (L, 4)) of each row."""
    for row in plan.rows:
        yield (*(int(v) for v in row[:msda_ops.TILE_HEADER]),
               row[msda_ops.TILE_HEADER:].reshape(n_levels, 4))


@pytest.mark.parametrize("head_dim", [64, 128, 6])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tile_plan_covers_every_query_once(case, head_dim):
    grids, levels, plan = _plan(case, head_dim)
    Nq = sum(a * b for a, b in grids)
    seen = np.zeros(Nq, np.int64)
    starts = np.cumsum([0] + [a * b for a, b in grids])
    for q_start, Wq, y0, x0, th, tw, _ in _plan_tiles(plan, len(levels)):
        g = int(np.searchsorted(starts, q_start, side="right")) - 1
        assert q_start == starts[g] and Wq == grids[g][1]
        assert 0 < th * tw <= msda_ops.MAX_TILE_QUERIES
        assert y0 + th <= grids[g][0] and x0 + tw <= Wq
        ys, xs = np.meshgrid(np.arange(y0, y0 + th), np.arange(x0, x0 + tw),
                             indexing="ij")
        seen[q_start + ys * Wq + xs] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tile_plan_windows_hold_what_their_queries_reach(case):
    """A staged rectangle contains anchor ± (R + 1) of each of the tile's
    queries, clipped to the level, and fits the shared memory the kernels
    ask for: two blocks on an SM."""
    grids, levels, plan = _plan(case)
    starts = np.cumsum([0] + [a * b for a, b in grids])
    for q_start, Wq, y0, x0, th, tw, rects in _plan_tiles(plan, len(levels)):
        Hq = grids[int(np.searchsorted(starts, q_start, side="right")) - 1][0]
        for (Hl, Wl), (y_lo, x_lo, rh, rw) in zip(levels, rects):
            if rh == 0:
                continue
            assert 0 <= y_lo and y_lo + rh <= Hl
            assert 0 <= x_lo and x_lo + rw <= Wl
            assert rh * rw * 64 <= plan.stage_elems
            ay = msda_ops.axis_anchor_residual(Hq, Hl)[0][y0:y0 + th]
            ax = msda_ops.axis_anchor_residual(Wq, Wl)[0][x0:x0 + tw]
            assert y_lo <= max(ay.min() - (R + 1), 0)
            assert y_lo + rh - 1 >= min(ay.max() + (R + 1), Hl - 1)
            assert x_lo <= max(ax.min() - (R + 1), 0)
            assert x_lo + rw - 1 >= min(ax.max() + (R + 1), Wl - 1)
    assert plan.stage_elems % 4 == 0 and plan.stage_elems > 0
    # 1 KB of an SM's shared memory is reserved per resident block
    assert 2 * (msda_ops.shared_bytes(plan.stage_elems, 64, 16) + 1024) \
        <= msda_ops.SM_SHARED_BYTES


def test_tile_plan_stages_what_fits_and_marks_the_rest():
    staged = {}
    for case in ("serve_cross", "train_cross", "serve_self_hi1"):
        grids, levels, plan = _plan(case)
        starts = np.cumsum([0] + [a * b for a, b in grids])
        for q_start, *_, rects in _plan_tiles(plan, len(levels)):
            g = int(np.searchsorted(starts, q_start, side="right")) - 1
            for l in range(len(levels)):
                staged.setdefault((case, g, l), []).append(rects[l, 2] > 0)
    # the stem grid reaches every level through a staged window
    for case in ("serve_cross", "train_cross"):
        assert all(all(staged[case, 0, l]) for l in range(4))
    # the 11x38 grid over the 88x304 level: an 8x8 query tile spans ~74x74
    # pixels, 1.4 MB a head; it is gathered from device memory
    assert not any(staged["serve_self_hi1", 2, 0])
    # (of the 22x76 grid only clipped corner tiles fit)
    assert np.mean(staged["serve_self_hi1", 1, 0]) < 0.1
    # every grid sampling its own level or a coarser one is staged
    assert all(staged["serve_self_hi1", 0, 1])
    assert all(staged["serve_self_hi1", 1, 2])
    assert all(staged["serve_self_hi1", 2, 3])
    # without a radius nothing is staged and the queries are one row
    grids, levels, plan = _plan("serve_cross", radius=None)
    assert plan.stage_elems == 0
    assert (plan.rows[:, msda_ops.TILE_HEADER:] == 0).all()
    # a tighter budget stages fewer levels, never a larger window
    _, _, small = _plan("serve_cross", stage_bytes=40 * 1024)
    assert 0 < small.stage_elems * 4 <= 40 * 1024
    assert (small.rows[:, msda_ops.TILE_HEADER + 2] == 0).any()


@pytest.mark.parametrize("head_dim,want", [
    (64, (4, 16)), (32, (4, 8)), (24, (4, 8)), (128, (4, 32)), (100, (4, 32)),
    (8, (4, 4)), (4, (4, 4)), (1, (1, 32)), (30, (1, 32))])
def test_channel_lanes(head_dim, want):
    assert msda_ops.channel_lanes(head_dim) == want
    assert msda_ops.channel_lanes(head_dim, aligned=False) == (1, 32)
    vec, lanes = want
    assert vec * lanes * (4 if vec == 1 else 1) >= head_dim
    # two blocks fit an SM whatever the staged window
    budget = msda_ops.stage_budget(head_dim, lanes)
    assert 2 * (msda_ops.shared_bytes(budget // 4, head_dim, lanes) + 1024) \
        <= msda_ops.SM_SHARED_BYTES


def _emulate_tiled(value, levels, pos, w, plan):
    """What kernels B and C do with a plan, in numpy: per tile and level the
    staged rectangle is copied out of the value; a sample whose four
    (clamped) corners lie in it reads the copy, any other sample reads the
    value itself. Returns (out, share of samples read from a copy)."""
    B, S, h, d = value.shape
    Nq, L, P = pos.shape[1], pos.shape[3], pos.shape[4]
    out = np.zeros((B, Nq, h, d), np.float32)
    starts = np.cumsum([0] + [a * b for a, b in levels])
    n_staged = 0
    for q_start, Wq, y0, x0, th, tw, rects in _plan_tiles(plan, L):
        ys, xs = np.meshgrid(np.arange(y0, y0 + th), np.arange(x0, x0 + tw),
                             indexing="ij")
        q = (q_start + ys * Wq + xs).reshape(-1)
        for l, (Hl, Wl) in enumerate(levels):
            level = value[:, starts[l]:starts[l + 1]].reshape(B, Hl, Wl, h, d)
            y_lo, x_lo, rh, rw = (int(v) for v in rects[l])
            stage = level[:, y_lo:y_lo + rh, x_lo:x_lo + rw].copy()
            pq = pos[:, q][:, :, :, l]                  # (B, n, h, P, 2)
            x, y = pq[..., 0], pq[..., 1]
            x0f, y0f = np.floor(x), np.floor(y)
            fx, fy = x - x0f, y - y0f
            x0in, x1in = (x0f >= 0) & (x0f < Wl), (x0f >= -1) & (x0f < Wl - 1)
            y0in, y1in = (y0f >= 0) & (y0f < Hl), (y0f >= -1) & (y0f < Hl - 1)
            xi = np.clip(x0f, -1, Wl).astype(np.int64)
            yi = np.clip(y0f, -1, Hl).astype(np.int64)
            xa, xb = np.clip(xi, 0, Wl - 1), np.clip(xi + 1, 0, Wl - 1)
            ya, yb = np.clip(yi, 0, Hl - 1), np.clip(yi + 1, 0, Hl - 1)
            staged = ((xa >= x_lo) & (xb < x_lo + rw)
                      & (ya >= y_lo) & (yb < y_lo + rh))
            n_staged += int(staged.sum())
            bi = np.arange(B)[:, None, None, None]
            hi = np.arange(h)[None, None, :, None]
            acc = np.zeros(x.shape + (d,), np.float32)
            for yc, xc, inb, cw in (
                    (ya, xa, y0in & x0in, (1 - fx) * (1 - fy)),
                    (ya, xb, y0in & x1in, fx * (1 - fy)),
                    (yb, xa, y1in & x0in, (1 - fx) * fy),
                    (yb, xb, y1in & x1in, fx * fy)):
                direct = level[bi, yc, xc, hi]
                if rh:
                    ys_, xs_ = (np.clip(yc - y_lo, 0, rh - 1),
                                np.clip(xc - x_lo, 0, rw - 1))
                    direct = np.where(staged[..., None],
                                      stage[bi, ys_, xs_, hi], direct)
                acc += (cw * inb)[..., None] * direct
            out[:, q] += (w[:, q][:, :, :, l, :, None] * acc).sum(3)
    return out.reshape(B, Nq, h * d), n_staged / (B * Nq * h * L * P)


@pytest.mark.parametrize("spread,stage_bytes,share", [
    # raw offsets of a few pixels: every sample lies in its staged window
    (3.0, 64 * 1024, (1.0, 1.0)),
    # a budget that leaves the finest level to device memory
    (3.0, 8 * 4 * 150, (0.4, 0.8)),
    # a quarter of the samples thrown far out of their windows and levels
    (-1.0, 64 * 1024, (0.7, 0.95))])
def test_tiled_emulation_matches_plain(spread, stage_bytes, share):
    rng = np.random.default_rng(7)
    grids, levels = ((20, 37), (5, 10)), ((40, 74), (20, 37), (10, 19), (5, 10))
    B, h, d, P, L = 2, 2, 8, 3, len(levels)
    Nq = sum(a * b for a, b in grids)
    value = rng.standard_normal(
        (B, sum(a * b for a, b in levels), h, d)).astype(np.float32)
    raw = rng.normal(0, abs(spread), (B, Nq, h, L, P, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    pos = msda_ops.windowed_positions(torch.from_numpy(raw), grids, levels, R)
    if spread < 0:
        far = rng.uniform(size=pos.shape[:-1]) < 0.25
        kick = rng.choice([-1e9, -60.0, -7.5, 6.5, 45.0, 1e9], pos.shape)
        pos = pos + torch.from_numpy((kick * far[..., None]).astype(np.float32))
    plan = msda_ops.tile_plan(grids, levels, float(R), d, stage_bytes)
    assert len(plan.rows) > len(grids)
    got, staged_share = _emulate_tiled(value, levels, pos.numpy(), w, plan)
    want = msda_ops.msda_plain(torch.from_numpy(value), levels, pos,
                               torch.from_numpy(w))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)
    assert share[0] <= staged_share <= share[1], staged_share


def test_msda_window_arguments():
    """`query_shapes` and `window_radius` change no result and are checked
    before any device is looked at."""
    query_hw, levels, values, raw, w, _ = _msda_inputs("multi_ratio")
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, d) for v in values], axis=1))
    pos = msda_ops.windowed_positions(torch.from_numpy(raw), [query_hw],
                                      levels, R)
    w = torch.from_numpy(w)
    want = msda_ops.msda(value, levels, pos, w)
    got = msda_ops.msda(value, levels, pos, w, [query_hw], R)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="together"):
        msda_ops.msda(value, levels, pos, w, [query_hw])
    with pytest.raises(ValueError, match="together"):
        msda_ops.msda(value, levels, pos, w, window_radius=R)
    with pytest.raises(ValueError, match="add up"):
        msda_ops.msda(value, levels, pos, w, [(3, 3)], R)
    with pytest.raises(ValueError, match="positive"):
        msda_ops.msda(value, levels, pos, w, [query_hw], 0)
