"""Kernel B's bf16 yardstick and its instance's geometry, on the CPU.

The card holds kernel B's bf16 instance (csrc/msda_fwd_bf16.cu) against
`msda_plain` on the same bf16 value, both against float64 (chip_smoke.py
phase 13, tests/test_torch_kernels_cuda.py). Here that plain version is
held, at HAHI's head width d = 64 (smoke size: 2 heads, 3 small levels),
against the JAX package's sampler on the same bf16-cast values lifted to
f32, made from a numpy seed: `msda_sample_windowed(..., impl="tiled")` for
the windowed and compat rules, `msda_sample` for the exact rule.

Tolerance. The port sums in f32 and rounds the sum to bf16 once, to
nearest even; JAX keeps the f32 sum: at most half a bf16 ulp of each
element apart, plus the f32 sums' other order. Held to rtol 2^-8 (one bf16
ulp) plus an atol of 1e-5 of the largest magnitude.

Then the host's half of the instance: its lanes for each head width (16-
byte slices of 8 bf16 over 4, 8 or 16 lanes, the scalar instance where a
head is not whole 16-byte units or a tensor not 16-byte aligned); its stage
budget of 0 (it stages no window: its shared memory holds only its
records, and its corner reads hit L1), so that a hint's plan cuts 128-query
tiles and the card's plan gives it the order alone, and the budget that
tests/msda_plan_rules.py --budget gives it, which still leaves two blocks
an SM; which unhinted launches of B the corner rule plans and which it
leaves on the unplanned rows.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import hahi as jhahi
from gedepth_tpu.ops.msda import msda_sample, msda_sample_windowed
from gedepth_tpu_torch.ops import msda as msda_ops

torch.set_num_threads(1)
BF16 = torch.bfloat16
LEVELS = ((8, 16), (4, 8), (2, 4))
QUERY_HW = (8, 16)
D = 64


def _bf16_f32(a):
    """numpy f32 rounded to bf16, lifted back to f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    B, h, P, L = 2, 2, 4, len(LEVELS)
    Nq = QUERY_HW[0] * QUERY_HW[1]
    values = [_bf16_f32(rng.standard_normal((B, H_, W_, h, D)))
              for (H_, W_) in LEVELS]
    off = rng.normal(0, 3.0, (B, Nq, h, L, P, 2)).astype(np.float32)
    off[:, 1::5] *= 30.0            # some samples far outside every level
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    ref = rng.uniform(0, 1, (B, Nq, L, 2)).astype(np.float32)
    ref[:, ::7], ref[:, 3::7] = 0.0, 1.0      # on the image's very border
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, D) for v in values], axis=1)).to(BF16)
    return values, value, off, w, ref


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2.0 ** -8, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rule", ["windowed", "compat", "exact"])
def test_msda_plain_bf16_at_hahi_width_matches_jax(rule):
    values, value, off, w, ref = _inputs({"windowed": 11, "compat": 12,
                                          "exact": 13}[rule])
    jvalues = [jnp.asarray(v) for v in values]
    off_t, w_t, ref_t = (torch.from_numpy(a) for a in (off, w, ref))
    if rule == "exact":
        pos = msda_ops.exact_positions(ref_t, off_t, LEVELS)
        norm = np.array([[W_, H_] for (H_, W_) in LEVELS], np.float32)
        locs = (ref[:, :, None, :, None, :]
                + off / norm[None, None, None, :, None, :])
        want = msda_sample(jvalues, jnp.asarray(locs), jnp.asarray(w),
                           remat=False, sampling="bilinear",
                           impl="per_level")
    else:
        R = 4 if rule == "windowed" else 5
        if rule == "windowed":
            pos = msda_ops.windowed_positions(off_t, (QUERY_HW,), LEVELS, R)
            disp = R * jnp.tanh(jnp.asarray(off) / R)
        else:
            pos, _ = msda_ops.compat_positions(ref_t, off_t, (QUERY_HW,),
                                               LEVELS, R)
            disp = jnp.clip(jhahi.compat_delta_px(
                jnp.asarray(ref), jnp.asarray(off), (QUERY_HW,), LEVELS),
                -float(R), float(R))
        want = msda_sample_windowed(
            jvalues, disp, jnp.asarray(w), QUERY_HW, radius=R, remat=False,
            impl="tiled", precision=jax.lax.Precision.HIGHEST)
    got = msda_ops.msda(value, LEVELS, pos, w_t)
    assert got.dtype == BF16 and tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), np.asarray(want))
    # the f32 sum rounded once: the plain bf16 version is the f32 one's
    # output rounded to nearest even
    f32 = msda_ops.msda_plain(value.float(), LEVELS, pos, w_t)
    assert torch.equal(got, f32.to(BF16))


@pytest.mark.parametrize("head_dim,want", [
    (64, (8, 8)), (8, (8, 4)), (16, (8, 4)), (24, (8, 4)), (32, (8, 4)),
    (40, (8, 8)), (72, (8, 16)), (128, (8, 16)), (12, (1, 32)),
    (7, (1, 32)), (1, (1, 32))])
def test_forward_lanes_bf16(head_dim, want):
    """A launch of B on a bf16 value takes 16-byte slices of 8 bf16 over
    the fewest of 4, 8, 16 lanes (those of kernel C's bf16 instance); the
    scalar instance for a head that is not whole 16-byte units or tensors
    that are not 16-byte aligned; on an f32 value `channel_lanes`."""
    value = torch.zeros(1, 3, 2, head_dim, dtype=BF16)
    out = value.new_zeros(1, 5, 2 * head_dim)
    assert msda_ops._forward_geometry(value, out)[:2] == want
    shifted = torch.zeros(value.numel() + 1, dtype=BF16)[1:].view(
        value.shape)
    assert msda_ops._forward_geometry(shifted, out)[:2] == (1, 32)
    assert msda_ops._forward_geometry(value.float(), out.float())[:2] == \
        msda_ops.channel_lanes(head_dim)
    vec, lanes = want
    assert vec * lanes * (4 if vec == 1 else 1) >= head_dim


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("head_dim", [8, 16, 24, 64, 128, 12])
def test_bf16_forward_stages_nothing(head_dim, aligned):
    """B's bf16 instance reads every corner through L1: its stage budget is
    0, so a window hint's plan stages no level and cuts the largest query
    tiles (8x16: every lane group of the block holds a query), and the
    card's plan at that budget stages nothing either. The f32 instance's
    budget and layout are untouched."""
    _, lanes = msda_ops.lanes_of(head_dim, aligned, 2)
    assert msda_ops.STAGE_SHARE_FORWARD_BF16 == 0
    assert msda_ops.stage_budget(head_dim, lanes, 2) == 0
    assert msda_ops.shared_bytes(0, head_dim, lanes, 2) == \
        512 // lanes * min(lanes, 8) * 32 <= 16 * 1024
    levels = ((22, 38), (11, 19), (6, 10))
    plan = msda_ops.tile_plan(((11, 19), (6, 10)), levels, 4.0, head_dim, 0,
                              2)
    assert plan.stage_elems == 0 and plan.bin_pixels == 0
    assert not plan.rows[:, msda_ops.TILE_HEADER:].any()
    assert tuple(plan.rows[0, 4:6]) == msda_ops.TILE_CANDIDATES[0]
    shape = msda_ops.device_plan_shape(levels, 269, head_dim, 0, 2)
    assert (shape.max_pixels, shape.stage_elems) == (0, 0)
    f32_lanes = msda_ops.channel_lanes(head_dim, aligned)[1]
    assert msda_ops.stage_budget(head_dim, f32_lanes) == \
        msda_ops.BLOCK_SHARED_BYTES - msda_ops.shared_bytes(0, head_dim,
                                                            f32_lanes)
    assert msda_ops.shared_bytes(0, 64, 16) == 128 * 64 * 4 + 32 * 8 * 32
    assert msda_ops.stage_budget(64, 16) // 256 == 290


@pytest.mark.parametrize("share", [0.5, 1.0])
@pytest.mark.parametrize("head_dim", [8, 64, 128, 12])
def test_bf16_forward_stage_budget_leaves_two_blocks(head_dim, share,
                                                     monkeypatch):
    """The budget that tests/msda_plan_rules.py --budget gives B's bf16
    instance (STAGE_SHARE_FORWARD_BF16 of the room beside its records):
    whole 16-byte units, and a block that stages the largest window of its
    plan (the staged window rounded to 16 bytes, then the records) still
    leaves room for two blocks of 512 threads an SM; a hint's plan at that
    budget stages, and the card's plan of the same budget at most as many
    pixels as the budget holds."""
    monkeypatch.setattr(msda_ops, "STAGE_SHARE_FORWARD_BF16", share)
    _, lanes = msda_ops.lanes_of(head_dim, itemsize=2)
    budget = msda_ops.stage_budget(head_dim, lanes, 2)
    room = msda_ops.BLOCK_SHARED_BYTES - msda_ops.shared_bytes(
        0, head_dim, lanes, 2)
    assert budget % 16 == 0 and budget <= share * room < budget + 16
    levels = ((22, 38), (11, 19), (6, 10))
    plan = msda_ops.tile_plan(((11, 19), (6, 10)), levels, 4.0, head_dim,
                              budget, 2)
    shape = msda_ops.device_plan_shape(levels, 269, head_dim, budget, 2)
    assert plan.stage_elems > 0 and shape.stage_elems > 0
    for elems in (plan.stage_elems, shape.stage_elems):
        assert 2 * elems <= budget
        assert 2 * (msda_ops.shared_bytes(elems, head_dim, lanes, 2)
                    + 1024) <= msda_ops.SM_SHARED_BYTES


def test_bf16_forward_takes_the_card_plans_order():
    """Where B's bf16 instance takes the card's plan (a launch planned
    whatever its corners), it takes it at a budget of 0: `plan_plain` there
    orders the queries as it does at any budget (the keys and the
    permutation C's plan of the same launch takes) and stages no
    rectangle."""
    rng = np.random.default_rng(4)
    levels = ((44, 76), (22, 38))
    B, Nq, h, P = 2, 600, 2, 8
    pos = torch.from_numpy(rng.uniform(-2, 70, (B, Nq, h, 2, P, 2))
                           .astype(np.float32))
    pos[..., 1] *= 0.5
    lanes = msda_ops.lanes_of(64, itemsize=2)[1]
    plan = msda_ops.plan_plain(pos, levels, 64,
                               msda_ops.stage_budget(64, lanes, 2), 2)
    assert not plan.rows[:, msda_ops.TILE_HEADER:].any()
    c_lanes = msda_ops.lanes_of(64, itemsize=2)[1]
    c_plan = msda_ops.plan_plain(
        pos, levels, 64, msda_ops.stage_budget_backward(64, c_lanes, P, 2), 2)
    assert c_plan.rows[:, msda_ops.TILE_HEADER + 2::4].any()
    assert torch.equal(plan.keys, c_plan.keys)
    assert torch.equal(plan.perm, c_plan.perm)
    assert torch.equal(plan.rows[:, :msda_ops.TILE_HEADER],
                       c_plan.rows[:, :msda_ops.TILE_HEADER])


@pytest.mark.parametrize("dtype,head_dim,planned", [
    (BF16, 64, False), (torch.float32, 64, True), (BF16, 8, False),
    (torch.float32, 8, False), (BF16, 128, True), (torch.float32, 32, False)])
def test_corner_rule_of_b(dtype, head_dim, planned):
    """The corner rule (PLAN_MIN_CORNER_BYTES_FORWARD, measured by
    tests/msda_plan_rules.py): an unhinted launch of B plans from 256 bytes
    a corner on. B-bf16 at HAHI's d = 64 gains by the plan's order about
    what the plan's launches and host time cost, and stays on the unplanned
    rows, as B at BinsFormer's d = 8 does in either dtype. More levels than
    a plan holds never plan."""
    value = torch.empty(1, 6, 2, head_dim, dtype=dtype)
    pos = torch.empty(1, 4, 2, 1, 3, 2)
    reason = msda_ops._plan_reason(value, pos, True)
    assert reason == (None if planned else msda_ops.UNPLANNED_CORNER)
    many = torch.empty(1, 4, 2, msda_ops.PLAN_MAX_LEVELS + 1, 3, 2)
    assert msda_ops._plan_reason(value, many, True) == \
        msda_ops.UNPLANNED_LEVELS
