"""The narrow instance of kernels B and C, on the CPU.

Heads of one or two whole 16-byte slices with 16-byte aligned tensors (f32
d = 4 or 8, bf16 d = 8 or 16: BinsFormer's encoder has 8 heads of 8) take
the narrow instance (csrc/msda_narrow.cu), which the card holds to the
plain versions and to the wide instances (tests/test_torch_kernels_cuda.py,
chip_smoke.py phase 37). Here: which launches the narrow rule selects; what
a launch of it passes and counts (its entry, its instance key, the corner
rule's unplanned reason without a hint, no plan whatever the hint), with
the launcher replaced by a recorder, since the CPU has no kernel; and the
plain versions that the CPU runs, `msda_plain` and `msda_backward_plain`,
at d = 8 and BinsFormer-like shapes (3 levels, 8 heads of 8, 8 points, a
few hundred queries) against the JAX package's exact sampler
(`msda_sample`, impl="per_level") and its `jax.vjp`, on the same inputs made
from a numpy seed.

Tolerances. f32: the output to rtol 1e-5, atol 1e-6 (the same f32
products, summed in another order); the gradients to rtol 1e-4, atol 1e-5,
as tests/test_torch_msda.py holds them (d_pos is a difference of corner
dots, s01 − s00, which cancels: 5e-6 apart at its largest of ~2). bf16, as tests/test_torch_msda_bf16_forward.py and
test_torch_msda_bf16_backward.py hold it: the value cast to bf16 and
lifted to f32 for JAX; the port's output and d_value are f32 sums rounded
once to bf16, held to rtol 2^-8 (one bf16 ulp) plus 1e-5 of the largest
magnitude; d_pos and d_w, f32 on both sides, to rtol 1e-4 plus 1e-5 of the
largest magnitude.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.ops.msda import msda_sample
from gedepth_tpu_torch.ops import msda as msda_ops

torch.set_num_threads(1)
BF16 = torch.bfloat16
LEVELS = ((12, 16), (6, 8), (3, 4))        # 252 queries, BinsFormer-like
H, D, P = 8, 8, 8


@pytest.mark.parametrize("dtype,head_dim,aligned,want", [
    (torch.float32, 4, True, 1), (torch.float32, 8, True, 2),
    (BF16, 8, True, 1), (BF16, 16, True, 2),
    (torch.float32, 8, False, 0), (BF16, 8, False, 0),
    (torch.float32, 12, True, 0), (torch.float32, 16, True, 0),
    (torch.float32, 24, True, 0), (torch.float32, 64, True, 0),
    (BF16, 12, True, 0), (BF16, 24, True, 0), (BF16, 32, True, 0),
    (BF16, 64, True, 0), (torch.float32, 2, True, 0), (BF16, 4, True, 0)])
def test_narrow_rule(dtype, head_dim, aligned, want):
    """One or two whole 16-byte slices a head, 16-byte aligned tensors;
    every other launch takes the wide instances."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    assert msda_ops.narrow_slices(head_dim, itemsize, aligned) == want


class _Recorder:
    """Stands in for `_lib.call`: records each entry and its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        self.calls.append((name, args))


def _refuse(*args, **kwargs):
    raise AssertionError("a narrow launch made a plan")


def _cpu_launch(monkeypatch, dtype, d, P_, hint, offset=0, **kw):
    """`_launch_forward` and `_launch_backward` on CPU tensors with the
    launcher recorded and the plans refused; `offset` elements shift the
    value off its 16-byte alignment."""
    recorder = _Recorder()
    monkeypatch.setattr(msda_ops._lib, "call", recorder)
    if not kw:
        monkeypatch.setattr(msda_ops, "msda_plan", _refuse)
        monkeypatch.setattr(msda_ops, "tile_plan", _refuse)
    levels, B, Nq = ((4, 6), (2, 3)), 2, 10
    S = sum(a * b for a, b in levels)
    value = torch.zeros(B * S * 3 * d + offset, dtype=dtype)[offset:].view(
        B, S, 3, d)
    pos = torch.zeros(B, Nq, 3, 2, P_, 2)
    w = torch.zeros(B, Nq, 3, 2, P_)
    gout = torch.zeros(B, Nq, 3 * d, dtype=dtype)
    window = ((((2, 5),), 4.0) if hint else (((1, Nq),), None))
    out = msda_ops._launch_forward(value, levels, pos, w, window, **kw)
    grads = msda_ops._launch_backward(value, levels, pos, w, gout, window,
                                      **kw)
    assert out.shape == (B, Nq, 3 * d) and out.dtype == dtype
    assert [g.dtype for g in grads] == [dtype, torch.float32, torch.float32]
    return recorder.calls


@pytest.mark.parametrize("hint", [False, True])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 4), (torch.float32, 8),
                                     (BF16, 8), (BF16, 16)])
def test_narrow_launch_entry_key_and_reason(monkeypatch, dtype, d, hint):
    """A narrow launch calls the narrow entry of its dtype with the vector
    read of positions and weights where P is a multiple of 4, counts under
    (dtype, 'narrow', d) and, without a hint, under the corner rule's
    unplanned reason, and makes no plan, hinted or not."""
    key, reason = (dtype, msda_ops.NARROW, d), msda_ops.UNPLANNED_CORNER
    fwd, bwd = msda_ops.msda, msda_ops.msda_backward
    before = (fwd.launches, bwd.launches, fwd.launches_by_instance[key],
              bwd.launches_by_instance[key], fwd.unplanned[reason],
              bwd.unplanned[reason], fwd.launches_by_queries[10])
    suffix = "_bf16" if dtype == BF16 else ""
    for P_, vec in ((8, 1), (3, 0)):
        calls = _cpu_launch(monkeypatch, dtype, d, P_, hint)
        assert [name for name, _ in calls] == [
            "msda_narrow_fwd" + suffix, "msda_narrow_bwd" + suffix]
        # B, S, Nq, h, d, L, P and the vector read end each launch
        assert calls[0][1][-8:] == (2, 30, 10, 3, d, 2, P_, vec)
        assert calls[1][1][-8:] == (2, 30, 10, 3, d, 2, P_, vec)
    n = 0 if hint else 2
    assert (fwd.launches, bwd.launches, fwd.launches_by_instance[key],
            bwd.launches_by_instance[key], fwd.unplanned[reason],
            bwd.unplanned[reason], fwd.launches_by_queries[10]) == (
        before[0] + 2, before[1] + 2, before[2] + 2, before[3] + 2,
        before[4] + n, before[5] + n, before[6] + 2)


@pytest.mark.parametrize("kw", [{"wide": True}, {"planned": False}])
def test_wide_launch_at_narrow_width(monkeypatch, kw):
    """The private arguments keep the wide instance reachable at d = 8 (what
    the narrow one is held against on the card): `msda_wide` and the
    unplanned rows call the wide entries with their lane geometry."""
    calls = _cpu_launch(monkeypatch, torch.float32, 8, 8, False, **kw)
    assert [name for name, _ in calls] == ["msda_fwd", "msda_bwd"]
    assert calls[0][1][-2:] == calls[1][1][-2:] == (4, 4)


def test_unaligned_value_takes_the_wide_instance(monkeypatch):
    """A value off its 16-byte alignment is not narrow: the wide scalar
    instance reads it element by element."""
    for dtype, d in ((torch.float32, 8), (BF16, 8)):
        calls = _cpu_launch(monkeypatch, dtype, d, 8, True, offset=1,
                            wide=False)
        assert [name for name, _ in calls][0].startswith("msda_fwd")
        assert calls[0][1][-2:] == (1, 32)


def _inputs(seed, dtype, border):
    """BinsFormer-like inputs: per-level values (B, H, W, heads, d), exact
    offsets of 3 level pixels (a fifth of them 30x further: off every
    level), weights softmaxed over (L, P), reference points at the queries'
    grid centres or, with `border`, anywhere and on the image's edges."""
    rng = np.random.default_rng(seed)
    B, L = 2, len(LEVELS)
    Nq = sum(a * b for a, b in LEVELS)
    values = [rng.standard_normal((B, H_, W_, H, D)).astype(np.float32)
              for (H_, W_) in LEVELS]
    if dtype == BF16:
        values = [torch.from_numpy(v).to(BF16).float().numpy()
                  for v in values]
    off = rng.normal(0, 3.0, (B, Nq, H, L, P, 2)).astype(np.float32)
    off[:, 1::5] *= 30.0
    logits = rng.standard_normal((B, Nq, H, L * P)).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Nq, H, L, P)
    if border:
        ref = rng.uniform(0, 1, (B, Nq, L, 2)).astype(np.float32)
        ref[:, ::7], ref[:, 3::7] = 0.0, 1.0
    else:
        ref = np.broadcast_to(msda_ops.center_reference_points(
            LEVELS).numpy()[None], (B, Nq, L, 2)).copy()
    cot = rng.standard_normal((B, Nq, H * D)).astype(np.float32)
    if dtype == BF16:
        cot = torch.from_numpy(cot).to(BF16).float().numpy()
    value = torch.from_numpy(np.concatenate(
        [v.reshape(B, -1, H, D) for v in values], axis=1)).to(dtype)
    return values, value, off, w.astype(np.float32), ref, cot


def _locations(ref, off):
    norm = np.array([[W_, H_] for (H_, W_) in LEVELS], np.float32)
    return (ref[:, :, None, :, None, :]
            + off / norm[None, None, None, :, None, :]), norm


def _close(got, want, rtol, atol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def _bf16_tol(want, rtol):
    return rtol, 1e-5 * np.abs(np.asarray(want)).max()


F32_OUT, F32_GRAD = (1e-5, 1e-6), (1e-4, 1e-5)


@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_msda_plain_at_d8_matches_jax(dtype, border):
    values, value, off, w, ref, _ = _inputs(21 + border, dtype, border)
    pos = msda_ops.exact_positions(torch.from_numpy(ref),
                                   torch.from_numpy(off), LEVELS)
    locs, _ = _locations(ref, off)
    want = np.asarray(jax.jit(
        lambda vs, x, w_: msda_sample(list(vs), x, w_, remat=False,
                                      sampling="bilinear",
                                      impl="per_level"))(
        tuple(jnp.asarray(v) for v in values), jnp.asarray(locs),
        jnp.asarray(w)))
    got = msda_ops.msda(value, LEVELS, pos, torch.from_numpy(w))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    _close(got.float().numpy(), want, *(
        F32_OUT if dtype == torch.float32 else _bf16_tol(want, 2.0 ** -8)))


@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_msda_backward_plain_at_d8_matches_jax_vjp(dtype, border):
    values, value, off, w, ref, cot = _inputs(31 + border, dtype, border)
    pos = msda_ops.exact_positions(torch.from_numpy(ref),
                                   torch.from_numpy(off), LEVELS)
    locs, norm = _locations(ref, off)

    def pullback(vs, x, w_, ct):
        out, vjp = jax.vjp(
            lambda vs_, x_, ww: msda_sample(list(vs_), x_, ww, remat=False,
                                            sampling="bilinear",
                                            impl="per_level"), vs, x, w_)
        return vjp(ct.reshape(out.shape))

    gv, gx, gw = jax.jit(pullback)(
        tuple(jnp.asarray(v) for v in values), jnp.asarray(locs),
        jnp.asarray(w), jnp.asarray(cot))
    B = value.shape[0]
    want_v = np.concatenate([np.asarray(g).reshape(B, -1, H, D) for g in gv],
                            1)
    d_value, d_pos, d_w = msda_ops.msda_backward(
        value, LEVELS, pos, torch.from_numpy(w),
        torch.from_numpy(cot).to(dtype))
    assert (d_value.dtype, d_pos.dtype, d_w.dtype) == (
        dtype, torch.float32, torch.float32)
    f32 = dtype == torch.float32
    _close(d_value.float().numpy(), want_v,
           *(F32_GRAD if f32 else _bf16_tol(want_v, 2.0 ** -8)))
    # d loc = d pos · (W_l, H_l)
    for got, want in ((d_pos.numpy() * norm[None, None, None, :, None, :],
                       np.asarray(gx)), (d_w.numpy(), np.asarray(gw))):
        _close(got, want, *(F32_GRAD if f32 else _bf16_tol(want, 1e-4)))
