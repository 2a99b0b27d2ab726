"""Kernel C's bf16 yardstick and its instance's geometry, on the CPU.

The card holds kernel C's bf16 instance (csrc/msda_bwd_bf16.cu) against
`msda_backward_plain` on the same bf16 value and grad_out (chip_smoke.py
phase 13, tests/test_torch_kernels_cuda.py). Here that plain version is held
against `jax.vjp` of the JAX package's sampler, at smoke width, for the
windowed rule (`msda_sample_windowed(..., impl="tiled")`) and the exact rule
(`msda_sample`), on the same bf16-cast values lifted to f32 on the JAX side,
made from a numpy seed.

Tolerances. d_pos and d_w are f32 on both sides, the same products summed
in another order: rtol 1e-4, atol 1e-5 of the largest magnitude. d_value is
rounded once to bf16 by the port (an f32 sum, then one rounding to nearest
even) and stays f32 in JAX: at most half a bf16 ulp of each element apart,
held to rtol 2^-8 (one ulp) plus the same atol.

Then the host's half of the bf16 instance: 16-byte slices of 8 bf16 over
4, 8 or 16 lanes, the scalar instance where a head is not whole 16-byte
units, a staged window that leaves room for two blocks of 512 threads on
an SM beside the one-pass block's rows, records, filed corners and bin
counts, and the windows it bins without staging them.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.ops.msda import msda_sample, msda_sample_windowed
from gedepth_tpu_torch.ops import msda as msda_ops

torch.set_num_threads(1)
BF16 = torch.bfloat16
R = 4
LEVELS = ((8, 16), (4, 8), (2, 4))
QUERY_HW = (8, 16)


def _bf16_f32(a):
    """numpy f32 rounded to bf16, lifted back to f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _inputs(seed, far):
    rng = np.random.default_rng(seed)
    B, h, d, P, L = 2, 2, 16, 3, len(LEVELS)
    Nq = QUERY_HW[0] * QUERY_HW[1]
    values = [_bf16_f32(rng.standard_normal((B, H_, W_, h, d)))
              for (H_, W_) in LEVELS]
    off = rng.normal(0, 3.0, (B, Nq, h, L, P, 2)).astype(np.float32)
    if far:     # some samples far outside every level (exact rule: the
        # windowed one bounds them, and at its saturated tanh a position
        # lands on the integers where the tiled taps' slope differs)
        off[:, 1::5] *= 30.0
    w = rng.uniform(0, 1, (B, Nq, h, L, P)).astype(np.float32)
    cot = _bf16_f32(rng.standard_normal((B, Nq, h * d)))
    ref = rng.uniform(0, 1, (B, Nq, L, 2)).astype(np.float32)
    ref[:, ::7], ref[:, 3::7] = 0.0, 1.0      # on the image's very border
    return values, off, w, cot, ref


def _jax_vjp(fn, values, x, w, cot):
    """jax.vjp of fn at (values, x, w) for the cotangent cot, jitted (one
    compile is quicker than the eager ops)."""
    def pullback(vs, x_, w_, ct):
        out, vjp = jax.vjp(fn, vs, x_, w_)
        return vjp(ct.reshape(out.shape))

    gv, gx, gw = jax.jit(pullback)(
        tuple(jnp.asarray(v) for v in values), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(cot))
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    gv = np.concatenate([np.asarray(g).reshape(B, -1, h, d) for g in gv], 1)
    return gv, np.asarray(gx), np.asarray(gw)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rule", ["windowed", "exact"])
def test_msda_backward_plain_bf16_matches_jax_vjp(rule):
    values, off, w, cot, ref = _inputs(7 if rule == "windowed" else 8,
                                       far=rule == "exact")
    B, h, d = values[0].shape[0], values[0].shape[3], values[0].shape[4]
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, h, d) for v in values], axis=1)).to(BF16)
    off_t, w_t = torch.from_numpy(off), torch.from_numpy(w)
    if rule == "windowed":
        pos = msda_ops.windowed_positions(off_t, (QUERY_HW,), LEVELS, R)
        disp = R * jnp.tanh(jnp.asarray(off) / R)
        want = _jax_vjp(
            lambda vs, x, w_: msda_sample_windowed(
                list(vs), x, w_, QUERY_HW, radius=R, remat=False,
                impl="tiled", precision=jax.lax.Precision.HIGHEST),
            values, disp, w, cot)
        scale = np.ones(2, np.float32)        # d pos / d displacement = 1
    else:
        pos = msda_ops.exact_positions(torch.from_numpy(ref), off_t, LEVELS)
        norm = np.array([[W_, H_] for (H_, W_) in LEVELS], np.float32)
        locs = (ref[:, :, None, :, None, :]
                + off / norm[None, None, None, :, None, :])
        want = _jax_vjp(
            lambda vs, x, w_: msda_sample(list(vs), x, w_, remat=False,
                                          sampling="bilinear",
                                          impl="per_level"),
            values, locs, w, cot)
        scale = norm[None, None, None, :, None, :]  # d pos / d loc
    d_value, d_pos, d_w = msda_ops.msda_backward(
        value, LEVELS, pos, w_t, torch.from_numpy(cot).to(BF16))
    assert (d_value.dtype, d_pos.dtype, d_w.dtype) == (
        BF16, torch.float32, torch.float32)
    _close(d_value.float().numpy(), want[0], 2.0 ** -8)
    _close(d_pos.numpy() * scale, want[1], 1e-4)
    _close(d_w.numpy(), want[2], 1e-4)


@pytest.mark.parametrize("head_dim,want", [
    (64, (8, 8)), (32, (8, 4)), (24, (8, 4)), (8, (8, 4)), (128, (8, 16)),
    (120, (8, 16)), (12, (1, 32)), (7, (1, 32)), (1, (1, 32))])
def test_backward_lanes_bf16(head_dim, want):
    """16-byte slices of 8 bf16 over the fewest of 4, 8, 16 lanes; the
    scalar instance for a head that is not whole 16-byte units or for
    tensors that are not 16-byte aligned; f32 keeps `channel_lanes`."""
    assert msda_ops.lanes_of(head_dim, itemsize=2) == want
    assert msda_ops.lanes_of(head_dim, aligned=False, itemsize=2) == (1, 32)
    assert msda_ops.lanes_of(head_dim) == msda_ops.channel_lanes(head_dim)
    vec, lanes = want
    assert vec * lanes * (4 if vec == 1 else 1) >= head_dim


@pytest.mark.parametrize("points", [3, 4, 8, 16])
@pytest.mark.parametrize("head_dim", [64, 32, 8, 128, 12])
def test_bf16_backward_block_leaves_two_blocks_an_sm(head_dim, points):
    """The staged window the budget allows, beside the block's rows,
    records, filed corners and the counts of its largest bin window (the
    sorted corners share the window's region), fits two blocks of 512
    threads (each with 1 KB reserved) in an SM's 227 KB, and so does a
    block that bins without staging. At 16 points a tile's corners alone
    would crowd the block: it stages and bins nothing and adds every corner
    to device memory."""
    _, lanes = msda_ops.lanes_of(head_dim, itemsize=2)
    budget = msda_ops.stage_budget_backward(head_dim, lanes, points, 2)
    bins = msda_ops.backward_bins(head_dim, budget, 2)
    pixels = budget // (2 * head_dim)
    assert (pixels > 0) == (bins > 0) == (points <= 8)
    assert bins >= max(pixels, msda_ops.BIN_PIXELS_BACKWARD * (points <= 8))
    stage_elems = -(-pixels * head_dim // 8) * 8
    for elems in (stage_elems, 0):
        used = msda_ops.shared_bytes_backward(elems, head_dim, lanes, points,
                                              2, bins)
        assert 2 * (used + 1024) <= msda_ops.SM_SHARED_BYTES


def test_bf16_backward_shared_bytes_at_hahi_width():
    """At d = 64, P = 8 (HAHI): 8 lanes a query, 64 groups of 8 records of
    32 bytes; the tile's g rows 16 KB in bf16; 4,096 corner slots of 8
    bytes, filed and sorted (the sorted ones in the window's region); a
    count for each pixel of a bin window; a window of at least the 18x18
    pixels that an 8x8 query tile reaches at R = 4 on its own level (the
    f32 instance's budget holds 290; B's bf16 instance stages nothing)."""
    lanes = msda_ops.lanes_of(64, itemsize=2)[1]
    assert lanes == 8
    fixed = 128 * 64 * 2 + 64 * 8 * 32
    assert msda_ops.shared_bytes_backward(0, 64, lanes, 8, 2) == fixed
    # a one-pixel window: the region is the sorted corners'
    assert msda_ops.shared_bytes_backward(64, 64, lanes, 8, 2, 1) == \
        fixed + 2 * 128 * 8 * 4 * 8 + 4 * 2
    # a large one: the window's
    assert msda_ops.shared_bytes_backward(300 * 64, 64, lanes, 8, 2, 700) \
        == fixed + 300 * 128 + 128 * 8 * 4 * 8 + 4 * 701
    pixels = msda_ops.stage_budget_backward(64, lanes, 8, 2) // 128
    assert pixels >= 18 * 18 > msda_ops.stage_budget(64, 16) // 256
    # the f32 budget and B's lanes are untouched by C-bf16's geometry
    assert msda_ops.stage_budget_backward(64, 16, 8) == \
        msda_ops.stage_budget(64, 16)
    assert msda_ops.backward_bins(64, msda_ops.stage_budget(64, 16)) == 0


def test_bf16_backward_plan_bins_what_it_cannot_stage():
    """The hinted plan of a bf16 launch of C at the train crop's windowed
    self-attention: the 44x88 query grid's windows on the 88x176 level
    outgrow the stage and are binned alone (height negated, within the bin
    pixels); B's plan of the same launch, and the f32 plans, bin nothing."""
    levels = ((88, 176), (44, 88), (22, 44), (11, 22))
    grids = levels[1:]
    lanes = msda_ops.lanes_of(64, itemsize=2)[1]
    budget = msda_ops.stage_budget_backward(64, lanes, 8, 2)
    bins = msda_ops.backward_bins(64, budget, 2)
    plan = msda_ops.tile_plan(grids, levels, float(R), 64, budget, 2, bins)
    rects = plan.rows[:, msda_ops.TILE_HEADER:].reshape(len(plan.rows), -1, 4)
    alone = rects[:, :, 2] < 0
    assert alone[:, 0].sum() > 0.5 * len(plan.rows)
    assert 0 < plan.bin_pixels <= bins
    assert (np.abs(rects[..., 2]) * rects[..., 3]).max() == plan.bin_pixels
    assert (rects[:, :, 2] * rects[:, :, 3]).max() * 64 <= plan.stage_elems
    for other in (msda_ops.tile_plan(grids, levels, float(R), 64,
                                     msda_ops.stage_budget(64, 16), 2),
                  msda_ops.tile_plan(grids, levels, float(R), 64,
                                     msda_ops.stage_budget(64, 16), 4)):
        assert (other.rows[:, msda_ops.TILE_HEADER + 2::4] >= 0).all()
        assert other.bin_pixels * 64 <= other.stage_elems


def test_bf16_backward_plans_with_its_own_budget():
    """Without a hint the card's plan of a bf16 launch of C is sized by
    C-bf16's budget: `plan_plain` with it stages no rectangle past the
    pixels the one-pass block holds."""
    rng = np.random.default_rng(3)
    levels = ((22, 44), (11, 22))
    B, Nq, h, P = 1, 300, 2, 8
    pos = torch.from_numpy(rng.uniform(-2, 40, (B, Nq, h, 2, P, 2))
                           .astype(np.float32))
    lanes = msda_ops.lanes_of(64, itemsize=2)[1]
    budget = msda_ops.stage_budget_backward(64, lanes, P, 2)
    plan = msda_ops.plan_plain(pos, levels, 64, budget, 2)
    rects = plan.rows[:, msda_ops.TILE_HEADER:].reshape(-1, 2, 4)
    pixels = (rects[..., 2] * rects[..., 3]).max().item()
    assert 0 < pixels <= budget // 128
