"""The tile plan that the card makes from the sample positions, in its plain
version (`gedepth_tpu_torch.ops.msda.plan_plain`), on the CPU.

Kernels B and C take, for a launch without a window hint, a plan made from
the positions (csrc/msda_plan.cu, held to `plan_plain` integer for integer
by tests/test_torch_kernels_cuda.py): each query's key, a robust centre of
its samples on the finest level; the queries of each entry ordered by key;
a tile of each 128 of that order with a rectangle to stage per level. Here:
the plan is a permutation of each entry's queries; ties keep query order
and two runs agree; every rectangle lies inside its level and within the
stage budget, and holds the counted samples the plan says it holds; keys ignore samples thrown off the level and queries with no
sample on it; and sampling the queries in plan order with `msda_plain`,
then putting each row back at its query, equals the JAX package's exact
`msda_sample` on the same seeded numpy inputs (rtol 1e-5, atol 1e-6: the
same sums, JAX's in another order), for grid-centre anchors (the
self-attention) and anchors anywhere (the learned cross-attention).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gedepth_tpu.ops.msda import msda_sample
from gedepth_tpu_torch.ops import msda as msda_ops

from test_torch_sampling_modes import _jax_locations, _rule_inputs

torch.set_num_threads(1)

LEVELS = ((24, 40), (12, 20), (6, 10))
D = 8
BUDGET = msda_ops.stage_budget(D, msda_ops.channel_lanes(D)[1])


def _exact_pos(rng, query_shapes, levels=LEVELS, B=2, h=2, P=4,
               learned=True, spread=3.0):
    ref, off, w = _rule_inputs(rng, query_shapes, levels, B=B, h=h, P=P,
                               learned=learned, spread=spread)
    pos = msda_ops.exact_positions(torch.from_numpy(ref),
                                   torch.from_numpy(off), levels)
    return ref, off, w, pos.contiguous()


def _plan(pos, levels=LEVELS):
    return msda_ops.plan_plain(pos, levels, D, BUDGET, 4)


def _counted_inside(pos, plan, levels=LEVELS):
    """(touching, inside), (B·T, L): for every PLAN_SHARE_STRIDE-th query
    of each tile in plan order, its samples with a corner on the level, and
    those whose four corners, clamped to the level as kernels B and C clamp
    them, lie in the tile's rectangle there. Counted here from the
    positions and the rows alone."""
    B, Nq = pos.shape[:2]
    Q = msda_ops.MAX_TILE_QUERIES
    T = -(-Nq // Q)
    rects = plan.rows[:, msda_ops.TILE_HEADER:].view(B * T, len(levels),
                                                     4).long()
    touching = torch.zeros(B * T, len(levels), dtype=torch.long)
    inside = torch.zeros_like(touching)
    for b in range(B):
        for t in range(T):
            qs = plan.perm[b, t * Q:(t + 1) * Q:msda_ops.PLAN_SHARE_STRIDE]
            for l, (Hl, Wl) in enumerate(levels):
                xy = pos[b, qs.long(), :, l].floor()
                x0, y0 = xy[..., 0], xy[..., 1]
                touch = (x0 >= -1) & (x0 < Wl) & (y0 >= -1) & (y0 < Hl)
                ry, rx, rh, rw = rects[b * T + t, l].tolist()
                held = (touch & (x0.clamp_min(0) >= rx)
                        & ((x0 + 1).clamp_max(Wl - 1) < rx + rw)
                        & (y0.clamp_min(0) >= ry)
                        & ((y0 + 1).clamp_max(Hl - 1) < ry + rh))
                touching[b * T + t, l] = touch.sum()
                inside[b * T + t, l] = held.sum()
    return touching, inside


def test_plan_is_a_permutation_of_each_entry():
    rng = np.random.default_rng(0)
    _, _, _, pos = _exact_pos(rng, ((20, 33),))      # 660: 5 full tiles + 20
    B, Nq = pos.shape[:2]
    plan = _plan(pos)
    assert plan.perm.shape == (B, Nq) and plan.perm.dtype == torch.int32
    for b in range(B):
        assert torch.equal(plan.perm[b].sort().values,
                           torch.arange(Nq, dtype=torch.int32))
    # the entries have their own offsets, and their own orders
    assert not torch.equal(plan.perm[0], plan.perm[1])
    T = -(-Nq // msda_ops.MAX_TILE_QUERIES)
    rows = plan.rows.view(B, T, -1)
    starts = (torch.arange(B)[:, None] * Nq
              + torch.arange(T)[None] * msda_ops.MAX_TILE_QUERIES)
    assert torch.equal(rows[..., 0], starts.to(torch.int32))
    counts = rows[..., 5]
    assert (counts.sum(1) == Nq).all() and counts[:, -1].eq(20).all()
    # the kernels' Tile: one row of tw queries read through perm
    assert (rows[..., 4] == 1).all() and (rows[..., 1] == -1).all()
    # the keys, read in plan order, do not decrease
    keys = plan.keys.gather(1, plan.perm.long())
    assert (keys[:, 1:] >= keys[:, :-1]).all()


def test_plan_ties_keep_query_order_and_runs_agree():
    """Queries around 3 points only: long runs of equal keys, each in query
    order; the plan of a second run is the same, integer for integer."""
    rng = np.random.default_rng(1)
    ref, off, w = _rule_inputs(rng, ((16, 20),), LEVELS, learned=True,
                               spread=0.3)
    ref[:] = np.array([[0.2, 0.3], [0.7, 0.6], [0.5, 0.9]],
                      np.float32)[rng.integers(0, 3, ref.shape[:2])][:, :,
                                                                     None]
    pos = msda_ops.exact_positions(torch.from_numpy(ref),
                                   torch.from_numpy(off), LEVELS).contiguous()
    plan, again = _plan(pos), _plan(pos)
    for name in ("keys", "perm", "rows"):
        assert torch.equal(getattr(plan, name), getattr(again, name))
    keys = plan.keys.gather(1, plan.perm.long())
    same = keys[:, 1:] == keys[:, :-1]
    assert same.float().mean() > 0.9
    assert (plan.perm[:, 1:] > plan.perm[:, :-1])[same].all()
    want = torch.sort(plan.keys.long(), dim=1, stable=True).indices
    assert torch.equal(plan.perm.long(), want)


@pytest.mark.parametrize("spread", [1.0, 3.0, 40.0])
@pytest.mark.parametrize("learned", [False, True])
def test_plan_rectangles_lie_inside_levels_within_budget(learned, spread):
    rng = np.random.default_rng(2)
    query_shapes = ((24, 40),) if learned else LEVELS
    _, _, _, pos = _exact_pos(rng, query_shapes, learned=learned,
                              spread=spread)
    max_pixels = BUDGET // (4 * D)
    plan = _plan(pos)
    rects = plan.rows[:, msda_ops.TILE_HEADER:].view(
        len(plan.rows), len(LEVELS), 4)
    for l, (Hl, Wl) in enumerate(LEVELS):
        y0, x0, rh, rw = rects[:, l].unbind(-1)
        on = rh > 0
        assert (rects[:, l][~on] == 0).all()
        assert (y0[on] >= 0).all() and (x0[on] >= 0).all()
        assert (y0 + rh <= Hl)[on].all() and (x0 + rw <= Wl)[on].all()
        assert (rh * rw <= max_pixels).all() and (rw[on] > 0).all()
        # a staged level is one a counted sample touches
        assert (plan.touched[on, l] > 0).all()
    if spread == 1.0:
        # narrow offsets: the coarse levels are staged by every tile
        assert (rects[:, 1:, 2] > 0).all()


@pytest.mark.parametrize("spread", [1.0, 3.0, 40.0])
@pytest.mark.parametrize("learned", [False, True])
def test_staged_rectangles_hold_the_counted_samples(learned, spread):
    """Each staged rectangle holds the counted samples the plan reports
    as staged, counted afresh from the positions: exactly where the margin
    reached PLAN_COVER_PCT percent of them, at least as many where the
    budget stopped it first; and the plan's count of touching samples is
    the positions' own."""
    rng = np.random.default_rng(5)
    query_shapes = ((24, 40),) if learned else LEVELS
    _, _, _, pos = _exact_pos(rng, query_shapes, learned=learned,
                              spread=spread)
    plan = _plan(pos)
    touching, inside = _counted_inside(pos, plan)
    on = plan.rows[:, msda_ops.TILE_HEADER + 2::4] > 0
    assert on.any()
    assert torch.equal(plan.touched[on], touching[on])
    covered = on & (100 * plan.staged >= msda_ops.PLAN_COVER_PCT
                    * plan.touched)
    assert torch.equal(inside[covered], plan.staged[covered])
    assert (inside[on] >= plan.staged[on]).all()
    assert (inside[on] <= touching[on]).all()
    if spread <= 3.0:
        assert covered.any()


def test_keys_ignore_thrown_samples_and_queries_off_the_level():
    """Each query's samples at one pixel of the finest level: its key is
    that pixel's cell. Throwing a twentieth of them a million pixels away
    (off the level), or tens of pixels (on it), or making them NaN, keeps
    the key; a query with no sample touching the finest level gets the
    last id and goes to the end of the order."""
    rng = np.random.default_rng(3)
    B, Nq, h, P, L = 2, 300, 4, 8, len(LEVELS)
    plan = msda_ops.device_plan_shape(LEVELS, Nq, D, BUDGET, 4)
    H0, W0 = LEVELS[plan.level0]
    px = np.stack([rng.integers(0, W0, (B, Nq)), rng.integers(0, H0, (B, Nq))],
                  -1).astype(np.float32) + 0.25
    pos = np.broadcast_to(px[:, :, None, None, None, :],
                          (B, Nq, h, L, P, 2)).copy()
    base = msda_ops.plan_keys_plain(torch.from_numpy(pos), LEVELS, plan)
    cells = torch.from_numpy(px.astype(np.int64)) >> plan.shift
    want = msda_ops._cells_of(base, plan.n_tx)
    assert torch.equal(want[0], cells[..., 1])
    assert torch.equal(want[1], cells[..., 0])
    thrown = pos.copy()
    kick = rng.uniform(size=(B, Nq, h, L, P)) < 0.05
    far = rng.uniform(size=kick.shape) < 0.5
    thrown[kick & far] += 1e6
    thrown[kick & ~far] += rng.choice([-30.0, 30.0], size=((kick & ~far).sum(),
                                                           2))
    thrown[(rng.uniform(size=kick.shape) < 0.01)] = np.nan
    got = msda_ops.plan_keys_plain(torch.from_numpy(thrown), LEVELS, plan)
    assert torch.equal(got, base)
    # queries 0..9 of entry 1 sample nothing on the finest level
    thrown[1, :10, :, plan.level0] = -5.0
    full = _plan(torch.from_numpy(thrown))
    assert (full.keys[1, :10] == plan.n_ids - 1).all()
    assert (full.keys[1, 10:] != plan.n_ids - 1).all()
    assert torch.equal(full.perm[1, -10:], torch.arange(10,
                                                        dtype=torch.int32))


@pytest.mark.parametrize("learned", [False, True])
def test_planned_order_samples_as_jax_exact(learned):
    """B in plan order: `msda_plain` over the permuted queries, each row
    put back at its query, against the JAX package's exact `msda_sample`.
    `msda_plain` samples each query alone, so this holds the permutation
    contract (every row back at its query), not what the plan stages:
    test_staged_rectangles_hold_the_counted_samples holds that, and the
    card's tests hold the planned kernels to the unplanned ones."""
    rng = np.random.default_rng(4)
    query_shapes = ((24, 40),) if learned else LEVELS
    B, h = 2, 2
    ref, off, w, pos = _exact_pos(rng, query_shapes, B=B, h=h,
                                  learned=learned)
    off[:, 1::9] *= 30.0            # some samples far off every level
    pos = msda_ops.exact_positions(torch.from_numpy(ref),
                                   torch.from_numpy(off), LEVELS).contiguous()
    values = [rng.standard_normal((B, H_, W_, h, D)).astype(np.float32)
              for (H_, W_) in LEVELS]
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, D) for v in values], axis=1))
    w_t = torch.from_numpy(w)
    plan = _plan(pos)
    idx = plan.perm.long()
    rows = torch.arange(B)[:, None]
    out_sorted = msda_ops.msda_plain(value, LEVELS, pos[rows, idx],
                                     w_t[rows, idx])
    got = torch.empty_like(out_sorted)
    got[rows, idx] = out_sorted
    want = np.asarray(msda_sample(
        [jnp.asarray(v) for v in values], _jax_locations(ref, off, LEVELS),
        jnp.asarray(w), remat=False, sampling="bilinear", impl="per_level"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plan_sizes_and_the_launches_it_cannot_take():
    """Cells of the finest level hold at most PLAN_CELL_QUERIES queries
    where the ids allow; a Cityscapes-size level still fits PLAN_MAX_IDS;
    the launches that take the unplanned rows are named; a key takes 32
    samples spread over a query's h·P."""
    serving = msda_ops.device_plan_shape(
        ((88, 304), (44, 152), (22, 76), (11, 38)), 107008, 64, 74240, 4)
    assert (serving.level0, serving.shift) == (0, 1)
    assert serving.n_tiles == 836 and serving.n_chunks == 105
    assert serving.max_pixels == 290 and serving.stage_elems == 290 * 64
    big = msda_ops.device_plan_shape(((256, 512), (128, 256)), 524288, 64,
                                     74240, 2)
    assert big.n_ids <= msda_ops.PLAN_MAX_IDS and big.max_pixels == 580
    value = torch.zeros(1, 30, 8, 64)
    pos = torch.zeros(1, 2, 8, 4, 8, 2)
    assert msda_ops._plan_reason(value, pos, True) is None
    assert msda_ops._plan_reason(value, torch.zeros(1, 2, 2, 9, 4, 2),
                                 False) == msda_ops.UNPLANNED_LEVELS
    # B plans from 256-byte corners (not bf16 or d = 8), C from 128 bytes
    # of f32 sums (bf16 at d = 64 too, not d = 8)
    bf16 = value.to(torch.bfloat16)
    assert msda_ops._plan_reason(bf16, pos, True) == msda_ops.UNPLANNED_CORNER
    assert msda_ops._plan_reason(bf16, pos, False) is None
    for forward in (True, False):
        assert msda_ops._plan_reason(torch.zeros(1, 30, 8, 8), pos,
                                     forward) == msda_ops.UNPLANNED_CORNER
    # keys take 32 samples spread over a query's h·P: 8 heads of 33 points
    big = torch.rand(2, 50, 8, 1, 33, 2) * 10
    plan = msda_ops.device_plan_shape(((10, 10),), 50, 8, 4096, 4)
    keys = msda_ops.plan_keys_plain(big, ((10, 10),), plan)
    spread = big[:, :, :, 0].reshape(2, 50, 264, 2)[
        :, :, torch.arange(32) * 264 // 32]
    want = msda_ops.plan_keys_plain(spread[:, :, :, None, None],
                                    ((10, 10),), plan)
    assert torch.equal(keys, want)
