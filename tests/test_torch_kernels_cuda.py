"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); every test here is marked `cuda`
and skips elsewhere. This file imports no JAX, and tests/conftest.py does,
so on a machine without JAX run it with:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances (f32, TF32 off): window attention and deformable sampling rtol
2e-4, atol 2e-5 (sums in another order, the kernel's exp against torch's;
window attention with logits of ~1e3, where one rounding of a logit moves
its weight by ~1e-4, is held to a float64 reference instead; at N = 49
kernel A rounds as the plain version and is held to it exactly);
PE fusion 1e-4, as on the CPU. The deformable-sampling backward (kernel C)
holds d_pos and d_weights to rtol 2e-4, atol 2e-5, and d_value, which is
summed in an order that changes from run to run, to rtol 2e-4 plus atol
1e-5·max|d_value|. Kernels B and C are run with the window hint
(`query_shapes`, `window_radius`: value windows staged in shared memory)
and without it (every corner from device memory); both must agree with the
plain versions for any positions: those of the windowed rule and those of
the exact, nearest and compat rules, whose reference points may sit on the
image border and whose offsets may be ±1e9. The bf16 instances of A, B and
C are held to float64 evaluations of their bf16 inputs (see the section at
the end of the file).
"""
import numpy as np
import pytest
import torch

from gedepth_tpu_torch.models.swin import shifted_window_mask
from gedepth_tpu_torch.ops import msda as msda_ops
from gedepth_tpu_torch.ops import pe_fusion as pe_ops
from gedepth_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda")


@pytest.mark.parametrize("nWB,H,D,grid", [
    (12, 2, 24, None), (8, 4, 32, (14, 28)), (572, 6, 32, (91, 308)),
    (44, 24, 32, (28, 77)), (6, 3, 64, (14, 21))])
def test_window_attention_kernel(nWB, H, D, grid):
    g = torch.Generator(device="cuda").manual_seed(0)
    N = 49
    q, k, v = (_randn(g, nWB, N, H, D) for _ in range(3))
    q = q * D ** -0.5
    bias = _randn(g, H, N, N)
    mask = None
    if grid is not None:
        mask = torch.as_tensor(shifted_window_mask(*grid, 7, 3),
                               device="cuda")
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    want = wa.window_attention_plain(q, k, v, bias, mask)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("query_shapes,levels", [
    (((5, 13),), ((10, 26), (5, 13))),
    (((3, 5),), ((12, 20), (6, 10), (3, 5))),
    (((44, 152), (22, 76), (11, 38)),
     ((88, 304), (44, 152), (22, 76), (11, 38))),
    (((176, 608),), ((88, 304), (44, 152), (22, 76), (11, 38)))])
def test_msda_kernel(query_shapes, levels):
    g = torch.Generator(device="cuda").manual_seed(1)
    B, h, d, P, L = 1, 8, 64, 8, len(levels)
    Nq = sum(a * b for a, b in query_shapes)
    S = sum(a * b for a, b in levels)
    value = _randn(g, B, S, h, d)
    raw = 2.0 * _randn(g, B, Nq, h, L, P, 2)
    pos = msda_ops.windowed_positions(raw, query_shapes, levels, 4)
    w = _randn(g, B, Nq, h, L * P).softmax(-1).view(B, Nq, h, L, P)
    before = msda_ops.msda.launches
    got = msda_ops.msda(value, levels, pos, w)
    torch.cuda.synchronize()
    assert msda_ops.msda.launches == before + 1
    want = msda_ops.msda_plain(value, levels, pos, w)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_window_attention_kernel_against_float64():
    """The kernel's own error against a float64 reference, independent of
    the f32 plain version (the two can round alike)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_randn(g, 154, 49, 12, 32) for _ in range(3))
    q = q * 32 ** -0.5
    bias = _randn(g, 12, 49, 49)
    mask = torch.as_tensor(shifted_window_mask(49, 154, 7, 3), device="cuda")
    got = wa.window_attention(q, k, v, bias, mask).double()
    ref = wa.window_attention_plain(
        *(t.double() for t in (q, k, v, bias, mask)))
    plain_err = (wa.window_attention_plain(q, k, v, bias, mask).double()
                 - ref).abs().max().item()
    err = (got - ref).abs().max().item()
    assert err < 1e-5 and err <= 4 * plain_err + 1e-7, (err, plain_err)


def _packed_qkv(g, nWB, N, H, D, scale=1.0):
    """q a scaled copy, k and v views into a packed (nWB, N, 3, H, D) qkv,
    as `WindowMSA` passes them."""
    qkv = _randn(g, nWB, N, 3, H, D) * scale
    return qkv[:, :, 0] * D ** -0.5, qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.parametrize("nWB,N,H,D,grid", [
    # stage 1 shifted at the train crop 352x704, batch 2: 2 x 338 windows
    (676, 49, 6, 32, (91, 182)),
    # a small batch-2 mask period (nWB = 2 nW), head width 24
    (16, 49, 2, 24, (14, 28)),
    # windows of 6x6 and 3x3 tokens (N < 49), with and without a mask
    (12, 36, 4, 32, (12, 18)), (10, 9, 3, 64, None)])
def test_window_attention_kernel_packed_qkv(nWB, N, H, D, grid):
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = _packed_qkv(g, nWB, N, H, D)
    assert not k.is_contiguous() and k.stride(1) == 3 * H * D
    bias = _randn(g, H, N, N)
    mask = None
    if grid is not None:
        win = int(round(N ** 0.5))
        mask = torch.as_tensor(shifted_window_mask(*grid, win, win // 2),
                               device="cuda")
        assert nWB == 2 * mask.shape[0]
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    want = wa.window_attention_plain(q, k, v, bias, mask)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_window_attention_kernel_large_logits():
    """|q·k| ~ 1e3: the row max is taken out before exp. Held, as the
    float64 test, to a float64 reference at no worse than 4x the plain
    f32 version's own error."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _packed_qkv(g, 44, 49, 24, 32, scale=16.0)
    v = v / 16.0
    bias = _randn(g, 24, 49, 49)
    mask = torch.as_tensor(shifted_window_mask(28, 77, 7, 3), device="cuda")
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    assert logits.abs().max().item() > 1e3
    got = wa.window_attention(q, k, v, bias, mask)
    assert bool(torch.isfinite(got).all())
    ref = wa.window_attention_plain(
        *(t.double() for t in (q, k, v, bias, mask)))
    plain_err = (wa.window_attention_plain(q, k, v, bias, mask).double()
                 - ref).abs().max().item()
    err = (got.double() - ref).abs().max().item()
    assert err <= 4 * plain_err + 1e-6, (err, plain_err)


@pytest.mark.parametrize("nWB,H,grid", [
    (572, 6, None), (44, 24, (28, 77)), (676, 6, (91, 182))])
def test_window_attention_kernel_equals_plain(nWB, H, grid):
    """At N = 49 kernel A sums, exponentiates and divides in the plain
    version's order, so the two agree bit for bit: a train step's gradients
    are sensitive to ~1e-7 relative changes in this op's output."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = _packed_qkv(g, nWB, 49, H, 32)
    bias = _randn(g, H, 49, 49)
    mask = None if grid is None else torch.as_tensor(
        shifted_window_mask(*grid, 7, 3), device="cuda")
    got = wa.window_attention(q, k, v, bias, mask)
    assert torch.equal(got, wa.window_attention_plain(q, k, v, bias, mask))


def _as_strided(shape, strides, offset=0):
    return torch.zeros(offset + 4096 * 64, device="cuda").as_strided(
        shape, strides, offset)


@pytest.mark.parametrize("case", [
    "float16", "float64", "N81", "D20", "last_stride", "head_stride",
    "row_stride", "misaligned", "bias_strided"])
def test_window_attention_kernel_refuses(case):
    """On a CUDA tensor the wrapper raises on what kernel A does not take,
    and launches nothing: no fallback to the plain version."""
    nWB, N, H, D = 4, 49, 2, 32
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = _packed_qkv(g, nWB, N, H, D)
    bias = _randn(g, H, N, N)
    mask = None
    row = H * D
    if case in ("float16", "float64"):
        dt = torch.float16 if case == "float16" else torch.float64
        q, k, v, bias = (t.to(dt) for t in (q, k, v, bias))
    elif case == "N81":
        q, k, v = (_randn(g, nWB, 81, H, D) for _ in range(3))
        bias = _randn(g, H, 81, 81)
    elif case == "D20":
        q, k, v = (_randn(g, nWB, N, H, 20) for _ in range(3))
    elif case == "last_stride":
        k = _randn(g, nWB, N, D, H).transpose(2, 3)
    elif case == "head_stride":
        k = _as_strided((nWB, N, H, D), (N * 2 * row, 2 * row, 2 * D, 1))
    elif case == "row_stride":
        v = _as_strided((nWB, N, H, D), (N * (row + 1), row + 1, D, 1))
    elif case == "misaligned":
        q = _as_strided((nWB, N, H, D), (N * row, row, D, 1), offset=1)
    elif case == "bias_strided":
        bias = bias.transpose(1, 2)
    before = wa.window_attention.launches
    with pytest.raises(TypeError if case.startswith("float") else ValueError):
        wa.window_attention(q, k, v, bias, mask)
    assert wa.window_attention.launches == before


def test_msda_kernel_zero_padding():
    value = torch.ones(1, 6, 1, 1, device="cuda")
    pos = torch.tensor([[-1.0, -1.0], [-0.5, 0.0], [1.0, 0.5], [2.5, 1.0],
                        [1e9, -1e9]], device="cuda").view(1, 5, 1, 1, 1, 2)
    w = torch.ones(1, 5, 1, 1, 1, device="cuda")
    got = msda_ops.msda(value, [(2, 3)], pos, w).view(-1).cpu()
    np.testing.assert_allclose(got.numpy(), [0.0, 0.5, 1.0, 0.5, 0.0])


@pytest.mark.parametrize("B,H,W", [(2, 32, 128), (1, 352, 1216)])
def test_pe_fusion_kernel(B, H, W):
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = _randn(g, B, H, W, 11)
    pe = torch.rand(B, H, W, generator=g, device="cuda") * 78 + 2
    y = torch.rand(B, H, W, generator=g, device="cuda")
    cam = torch.full((B,), 1.65, device="cuda")
    before = pe_ops.pe_fusion.launches
    got = pe_ops.pe_fusion(logits, pe, y, cam, 200.0)
    torch.cuda.synchronize()
    assert pe_ops.pe_fusion.launches == before + 1
    want = pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_raise_instead_of_falling_back():
    z = torch.zeros(1, 6, 1, 1)
    with pytest.raises(ValueError):   # kernel C has no CPU mode
        msda_ops.msda_backward(z, [(2, 3)], torch.zeros(1, 2, 1, 1, 1, 2),
                               torch.zeros(1, 2, 1, 1, 1), torch.zeros(1, 2, 1))
    q = torch.zeros(2, 49, 1, 8, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        wa.window_attention(q, q, q, torch.zeros(1, 49, 49, device="cuda",
                                                 dtype=torch.float64))
    x = torch.zeros(1, 4, 4, 11, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        pe_ops.pe_fusion(x, torch.zeros(1, 4, 4, device="cuda"),
                         torch.zeros(1, 4, 4, device="cuda"),
                         torch.ones(1, device="cuda"), 200.0)


def _assert_msda_grads(got, want):
    (dv, dp, dw), (dv_ref, dp_ref, dw_ref) = got, want
    torch.testing.assert_close(dp, dp_ref, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(dw, dw_ref, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(
        dv, dv_ref, rtol=2e-4, atol=1e-5 * dv_ref.abs().max().item())


@pytest.mark.parametrize("query_shapes,levels,B,h,d,spread", [
    # small shapes, odd head width (lanes past d idle)
    (((5, 13),), ((10, 26), (5, 13)), 2, 2, 24, 2.0),
    # a coarse query grid over a much finer level
    (((3, 5),), ((12, 20), (6, 10), (3, 5)), 1, 8, 64, 2.0),
    # raw offsets far past R: many corners fall outside the levels
    (((8, 16), (4, 8)), ((8, 16), (4, 8), (2, 4)), 2, 8, 64, 40.0),
    # the train crop's self-attention (hi_min_level 1), batch 2
    (((44, 88), (22, 44), (11, 22)),
     ((88, 176), (44, 88), (22, 44), (11, 22)), 2, 8, 64, 2.0)])
def test_msda_backward_kernel(query_shapes, levels, B, h, d, spread):
    g = torch.Generator(device="cuda").manual_seed(4)
    P, L = 4 if d < 64 else 8, len(levels)
    Nq = sum(a * b for a, b in query_shapes)
    S = sum(a * b for a, b in levels)
    value = _randn(g, B, S, h, d)
    raw = spread * _randn(g, B, Nq, h, L, P, 2)
    pos = msda_ops.windowed_positions(raw, query_shapes, levels, 4)
    w = _randn(g, B, Nq, h, L * P).softmax(-1).view(B, Nq, h, L, P)
    gout = _randn(g, B, Nq, h * d)
    before = msda_ops.msda_backward.launches
    got = msda_ops.msda_backward(value, levels, pos, w, gout)
    torch.cuda.synchronize()
    assert msda_ops.msda_backward.launches == before + 1
    _assert_msda_grads(got, msda_ops.msda_backward_plain(
        value, levels, pos, w, gout))


def test_msda_backward_kernel_zero_padding():
    """Corners outside the level give no gradient and receive no dV."""
    value = torch.arange(1.0, 7.0, device="cuda").view(1, 6, 1, 1)
    pos = torch.tensor([[-1.0, -1.0], [-0.5, 0.0], [1.0, 0.5], [2.5, 1.0],
                        [1e9, -1e9], [0.25, -0.75]],
                       device="cuda").view(1, 6, 1, 1, 1, 2)
    w = torch.full((1, 6, 1, 1, 1), 0.5, device="cuda")
    gout = torch.ones(1, 6, 1, device="cuda")
    got = msda_ops.msda_backward(value, [(2, 3)], pos, w, gout)
    want = msda_ops.msda_backward_plain(value, [(2, 3)], pos, w, gout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert got[1][0, 0].abs().max().item() == 0.0   # fully outside
    assert got[1][0, 4].abs().max().item() == 0.0


def test_msda_autograd_uses_kernels():
    """Autograd through `msda` on the card launches B forward and C
    backward, and its gradients equal autograd through the plain version."""
    g = torch.Generator(device="cuda").manual_seed(5)
    levels = ((8, 16), (4, 8))
    query_shapes = ((4, 8),)
    B, h, d, P = 2, 8, 64, 8
    value = _randn(g, B, 160, h, d)
    raw = 2.0 * _randn(g, B, 32, h, 2, P, 2)
    wl = _randn(g, B, 32, h, 2 * P)
    gout = _randn(g, B, 32, h * d)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (value, raw, wl)]
        pos = msda_ops.windowed_positions(leaves[1], query_shapes, levels, 4)
        w = leaves[2].softmax(-1).view(B, 32, h, 2, P)
        (fn(leaves[0], levels, pos, w) * gout).sum().backward()
        return [t.grad for t in leaves]

    fwd0 = msda_ops.msda.launches
    bwd0 = msda_ops.msda_backward.launches
    by_queries0 = (msda_ops.msda.launches_by_queries[32],
                   msda_ops.msda_backward.launches_by_queries[32])
    got = grads(msda_ops.msda)
    torch.cuda.synchronize()
    assert msda_ops.msda.launches == fwd0 + 1
    assert msda_ops.msda_backward.launches == bwd0 + 1
    assert (msda_ops.msda.launches_by_queries[32],
            msda_ops.msda_backward.launches_by_queries[32]) == (
                by_queries0[0] + 1, by_queries0[1] + 1)
    want = grads(msda_ops.msda_plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=1e-5 * b.abs().max().item())


# --- kernels B and C over their tile plan (staged windows, or device memory)

def _scatter(pos, g, share, far):
    """`share` of the samples moved by tens of pixels, or by `far`."""
    hit = torch.rand(pos.shape[:-1], generator=g, device="cuda") < share
    kick = 40.0 * torch.randn(pos.shape, generator=g, device="cuda")
    if far:
        kick = torch.where(kick > 0, far, -far)
    return pos + kick * hit[..., None]


TILE_EDGE_CASES = {
    # query grids, levels, B, h, d, P
    # grids that are no multiple of an 8x16 or 8x8 tile, three heads
    "ragged_grids": (((19, 37), (5, 3)), ((38, 74), (19, 37), (5, 3)),
                     2, 3, 64, 8),
    # levels of one pixel and one row
    "one_pixel_levels": (((9, 21),), ((9, 21), (1, 1), (1, 5)), 2, 8, 32, 4),
    # a coarse grid over a fine level: its window cannot be staged
    "coarse_over_fine": (((6, 10), (24, 40)), ((48, 80), (24, 40), (6, 10)),
                         1, 5, 64, 8),
    # widths of 8, 16 and 32 lanes with idle lanes, and the scalar instance
    "d24": (((17, 9),), ((17, 9), (9, 5)), 2, 2, 24, 3),
    "d128": (((17, 9),), ((17, 9), (9, 5)), 1, 2, 128, 8),
    "d100": (((17, 9),), ((17, 9), (9, 5)), 1, 2, 100, 8),
    "d6_scalar": (((17, 9),), ((17, 9), (9, 5)), 2, 3, 6, 8),
    "d70_scalar": (((17, 9),), ((17, 9), (9, 5)), 1, 2, 70, 9),
    # more points than a lane group sets up at once
    "p19": (((12, 20),), ((24, 40), (12, 20)), 1, 4, 32, 19),
    # so many points that the backward's corner list outgrows an SM: it
    # then runs without bins
    "p64": (((8, 8),), ((8, 8), (4, 4)), 1, 2, 16, 64),
}


@pytest.mark.parametrize("where", ["inside", "scattered", "far_out"])
@pytest.mark.parametrize("case", sorted(TILE_EDGE_CASES))
def test_msda_kernels_over_tile_plan(case, where):
    """B and C against their plain versions with the window hint, positions
    inside the window, a third of them scattered out of it, and a third at
    ±1e9; the same without the hint; d_pos and d_w equal over two runs."""
    query_shapes, levels, B, h, d, P = TILE_EDGE_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(11)
    L = len(levels)
    Nq = sum(a * b for a, b in query_shapes)
    S = sum(a * b for a, b in levels)
    value = _randn(g, B, S, h, d)
    raw = 3.0 * _randn(g, B, Nq, h, L, P, 2)
    pos = msda_ops.windowed_positions(raw, query_shapes, levels, 4)
    if where != "inside":
        pos = _scatter(pos, g, 0.33, 1e9 if where == "far_out" else 0.0)
    w = _randn(g, B, Nq, h, L * P).softmax(-1).view(B, Nq, h, L, P)
    gout = _randn(g, B, Nq, h * d)
    want = msda_ops.msda_plain(value, levels, pos, w)
    want_grads = msda_ops.msda_backward_plain(value, levels, pos, w, gout)
    for hint in ((query_shapes, 4), ()):
        got = msda_ops.msda(value, levels, pos, w, *hint)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        grads = msda_ops.msda_backward(value, levels, pos, w, gout, *hint)
        torch.cuda.synchronize()
        _assert_msda_grads(grads, want_grads)
        again = msda_ops.msda_backward(value, levels, pos, w, gout, *hint)
        assert torch.equal(grads[1], again[1])
        assert torch.equal(grads[2], again[2])


def test_msda_kernels_unaligned_value_take_the_scalar_instance():
    """A value that is not 16-byte aligned is read float by float."""
    g = torch.Generator(device="cuda").manual_seed(12)
    levels, query_shapes = ((16, 24), (8, 12)), ((16, 24),)
    B, h, d, P, S, Nq = 1, 2, 64, 8, 16 * 24 + 8 * 12, 16 * 24
    value = _randn(g, B * S * h * d + 1)[1:].view(B, S, h, d)
    assert value.data_ptr() % 16 == 4 and value.is_contiguous()
    pos = msda_ops.windowed_positions(
        3.0 * _randn(g, B, Nq, h, 2, P, 2), query_shapes, levels, 4)
    w = _randn(g, B, Nq, h, 2 * P).softmax(-1).view(B, Nq, h, 2, P)
    gout = _randn(g, B, Nq, h * d)
    got = msda_ops.msda(value, levels, pos, w, query_shapes, 4)
    torch.testing.assert_close(got, msda_ops.msda_plain(value, levels, pos, w),
                               rtol=2e-4, atol=2e-5)
    _assert_msda_grads(
        msda_ops.msda_backward(value, levels, pos, w, gout, query_shapes, 4),
        msda_ops.msda_backward_plain(value, levels, pos, w, gout))


@pytest.mark.parametrize("case", [
    "d132", "pos_unaligned", "radius_alone", "grids_alone", "grids_sum",
    "radius_zero", "level_2e31", "float64", "strided"])
def test_msda_kernels_refuse(case):
    """What kernels B and C do not take raises, for the forward and the
    backward alike, and launches nothing."""
    g = torch.Generator(device="cuda").manual_seed(13)
    levels, query_shapes = ((4, 6),), ((4, 6),)
    B, h, d, P, Nq = 1, 2, 8, 2, 24
    hint, error = (query_shapes, 4), ValueError
    if case == "level_2e31":
        levels = ((2 ** 12, 2 ** 12),)          # x 2 heads x 64 = 2^31
        d, hint = 64, ()
        value = torch.empty(B, 2 ** 24, h, d, device="cuda")
    else:
        if case == "d132":
            d = 132
        value = _randn(g, B, 24, h, d)
    pos = _randn(g, B, Nq, h, 1, P, 2)
    w = _randn(g, B, Nq, h, 1, P)
    if case == "pos_unaligned":
        pos = _randn(g, pos.numel() + 1)[1:].view(pos.shape)
        assert pos.data_ptr() % 8 == 4
    elif case == "radius_alone":
        hint = (None, 4)
    elif case == "grids_alone":
        hint = (query_shapes,)
    elif case == "grids_sum":
        hint = (((5, 5),), 4)
    elif case == "radius_zero":
        hint = (query_shapes, 0)
    elif case == "float64":
        value, pos, w, error = value.double(), pos.double(), w.double(), \
            TypeError
    elif case == "strided":
        w = _randn(g, B, Nq, h, 1, 2 * P)[..., ::2]
    gout = torch.zeros(B, Nq, h * d, device="cuda", dtype=value.dtype)
    before = msda_ops.msda.launches, msda_ops.msda_backward.launches
    with pytest.raises(error):
        msda_ops.msda(value, levels, pos, w, *hint)
    with pytest.raises(error):
        msda_ops.msda_backward(value, levels, pos, w, gout, *hint)
    assert before == (msda_ops.msda.launches, msda_ops.msda_backward.launches)


def test_msda_kernels_at_the_train_crop_with_the_hint():
    """The train crop's cross-attention (batch 2, 61,952 queries a sample)
    through the staged windows, a tenth of the samples scattered out."""
    g = torch.Generator(device="cuda").manual_seed(14)
    levels, query_shapes = ((88, 176), (44, 88), (22, 44), (11, 22)), \
        ((176, 352),)
    B, h, d, P, Nq = 2, 8, 64, 8, 176 * 352
    value = _randn(g, B, sum(a * b for a, b in levels), h, d)
    pos = msda_ops.windowed_positions(
        2.0 * _randn(g, B, Nq, h, 4, P, 2), query_shapes, levels, 4)
    pos = _scatter(pos, g, 0.1, 0.0)
    w = _randn(g, B, Nq, h, 4 * P).softmax(-1).view(B, Nq, h, 4, P)
    gout = _randn(g, B, Nq, h * d)
    torch.testing.assert_close(
        msda_ops.msda(value, levels, pos, w, query_shapes, 4),
        msda_ops.msda_plain(value, levels, pos, w), rtol=2e-4, atol=2e-5)
    _assert_msda_grads(
        msda_ops.msda_backward(value, levels, pos, w, gout, query_shapes, 4),
        msda_ops.msda_backward_plain(value, levels, pos, w, gout))


# --- DDAD's 384x640 shapes

DDAD_LEVELS = ((96, 160), (48, 80), (24, 40), (12, 20))


@pytest.mark.parametrize("nWB", [322, 644])
def test_window_attention_kernel_at_ddad_stage1(nWB):
    """Stage 1 of 96x160 padded to 98x161: 14x23 = 322 windows, the shift
    mask's period; batch 1 and 2."""
    g = torch.Generator(device="cuda").manual_seed(30)
    q, k, v = (_randn(g, nWB, 49, 6, 32) for _ in range(3))
    q = q * 32 ** -0.5
    bias = _randn(g, 6, 49, 49)
    mask = torch.as_tensor(shifted_window_mask(98, 161, 7, 3), device="cuda")
    assert mask.shape[0] == 322
    torch.testing.assert_close(wa.window_attention(q, k, v, bias, mask),
                               wa.window_attention_plain(q, k, v, bias, mask),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("query_shapes", [DDAD_LEVELS[1:], ((192, 320),)])
def test_msda_kernels_at_ddad_shapes(query_shapes, B):
    """B and C at DDAD's windowed self-attention (5,040 queries) and
    cross-attention (61,440) over 20,400 value tokens, with the window hint
    and without."""
    g = torch.Generator(device="cuda").manual_seed(31)
    Nq = sum(a * b for a, b in query_shapes)
    value = _randn(g, B, sum(a * b for a, b in DDAD_LEVELS), 8, 64)
    pos = msda_ops.windowed_positions(2.0 * _randn(g, B, Nq, 8, 4, 8, 2),
                                      query_shapes, DDAD_LEVELS, 4)
    w = _randn(g, B, Nq, 8, 32).softmax(-1).view(B, Nq, 8, 4, 8)
    gout = _randn(g, B, Nq, 512)
    want = msda_ops.msda_plain(value, DDAD_LEVELS, pos, w)
    want_grads = msda_ops.msda_backward_plain(value, DDAD_LEVELS, pos, w,
                                              gout)
    for window in ((query_shapes, 4), ()):
        torch.testing.assert_close(
            msda_ops.msda(value, DDAD_LEVELS, pos, w, *window), want,
            rtol=2e-4, atol=2e-5)
        _assert_msda_grads(msda_ops.msda_backward(value, DDAD_LEVELS, pos, w,
                                                  gout, *window), want_grads)


def test_msda_kernel_at_ddad_exact_positions():
    """The exact rule's self-attention over all of DDAD's levels (20,400
    queries), a tenth of the offsets far out."""
    g = torch.Generator(device="cuda").manual_seed(32)
    Nq = sum(a * b for a, b in DDAD_LEVELS)
    ref = msda_ops.center_reference_points(DDAD_LEVELS, "cuda")
    off = 3.0 * _randn(g, 1, Nq, 8, 4, 8, 2)
    far = torch.rand(off.shape, generator=g, device="cuda") < 0.1
    off = torch.where(far, off * 1e6, off)
    pos = msda_ops.exact_positions(ref, off, DDAD_LEVELS)
    value = _randn(g, 1, Nq, 8, 64)
    w = _randn(g, 1, Nq, 8, 32).softmax(-1).view(1, Nq, 8, 4, 8)
    torch.testing.assert_close(
        msda_ops.msda(value, DDAD_LEVELS, pos, w),
        msda_ops.msda_plain(value, DDAD_LEVELS, pos, w), rtol=2e-4,
        atol=2e-5)


def test_pe_fusion_kernel_per_sample_heights_ddad():
    """E at 384x640 with four camera heights in one batch and DDAD's
    depth_scale 250: each sample as if it were alone."""
    g = torch.Generator(device="cuda").manual_seed(33)
    logits = _randn(g, 4, 384, 640, 11)
    pe = torch.rand(4, 384, 640, generator=g, device="cuda") * 240 + 2
    y = torch.rand(4, 384, 640, generator=g, device="cuda")
    cam = torch.tensor([1.56, 1.57, 1.53, 1.55], device="cuda")
    got = pe_ops.pe_fusion(logits, pe, y, cam, 250.0)
    torch.testing.assert_close(
        got, pe_ops.pe_fusion_plain(logits, pe, y, cam, 250.0), rtol=1e-4,
        atol=1e-4)
    for i in range(4):
        torch.testing.assert_close(
            got[i:i + 1], pe_ops.pe_fusion(logits[i:i + 1], pe[i:i + 1],
                                           y[i:i + 1], cam[i:i + 1], 250.0))
    # the validity window is (0, 250]: a prior past 200 survives
    assert (got > 200).any()


# --- the exact, nearest and compat position rules through kernels B and C

RULE_SHAPES = {
    # query grids, levels, B, learned reference points
    "self": (((16, 24), (8, 12), (4, 6)), ((16, 24), (8, 12), (4, 6)), 2,
             False),
    "cross": (((32, 48),), ((16, 24), (8, 12), (4, 6)), 2, True),
    # the serving cross-attention at full width
    "serving_cross": (((176, 608),),
                      ((88, 304), (44, 152), (22, 76), (11, 38)), 1, True),
}


def _rule_positions(rule, g, case, extreme):
    """Positions of one rule. extreme: reference points of 0 and 1 (the
    image border) for a fifth of the queries each, and a tenth of the
    offsets at ±1e9."""
    query_shapes, levels, B, learned = RULE_SHAPES[case]
    Nq, L, h, P = sum(a * b for a, b in query_shapes), len(levels), 8, 8
    off = 3.0 * _randn(g, B, Nq, h, L, P, 2)
    if learned:
        ref = torch.rand(1, Nq, 1, 2, generator=g, device="cuda").expand(
            1, Nq, L, 2).contiguous()
    else:
        ref = msda_ops.center_reference_points(levels, "cuda").contiguous()
    if extreme:
        ref[..., 0::5, :, :] = 0.0
        ref[..., 1::5, :, :] = 1.0
        far = torch.rand(off.shape, generator=g, device="cuda") < 0.1
        off = torch.where(far, torch.where(off > 0, 1e9, -1e9), off)
    if rule == "compat":
        pos, delta = msda_ops.compat_positions(ref, off, query_shapes, levels,
                                               6)
        assert delta.abs().max().item() > 6     # the clamp is active
        assert (pos - msda_ops.anchored_positions(
            torch.zeros_like(pos), query_shapes, levels)).abs().max() <= 6.001
        return pos, (query_shapes, 6)
    form = (msda_ops.exact_positions if rule == "exact"
            else msda_ops.nearest_positions)
    pos = form(ref, off, levels)
    if rule == "nearest":
        assert torch.equal(pos, pos.floor())
    return pos, (query_shapes, 4)    # a hint these positions do not keep to


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("case", ["self", "cross"])
@pytest.mark.parametrize("rule", ["exact", "nearest", "compat"])
def test_msda_kernels_at_rule_positions(rule, case, extreme):
    """B and C against their plain versions at the positions of each rule,
    with a hint and without."""
    _, levels, B, _ = RULE_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(21)
    pos, hint = _rule_positions(rule, g, case, extreme)
    Nq, h, d = pos.shape[1], 8, 64
    value = _randn(g, B, sum(a * b for a, b in levels), h, d)
    w = _randn(g, B, Nq, h, len(levels) * 8).softmax(-1).view(
        B, Nq, h, len(levels), 8)
    gout = _randn(g, B, Nq, h * d)
    want = msda_ops.msda_plain(value, levels, pos, w)
    want_grads = msda_ops.msda_backward_plain(value, levels, pos, w, gout)
    assert bool(torch.isfinite(want).all())
    for window in (hint, ()):
        before = msda_ops.msda.launches, msda_ops.msda_backward.launches
        got = msda_ops.msda(value, levels, pos, w, *window)
        grads = msda_ops.msda_backward(value, levels, pos, w, gout, *window)
        torch.cuda.synchronize()
        assert (msda_ops.msda.launches, msda_ops.msda_backward.launches) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        _assert_msda_grads(grads, want_grads)


@pytest.mark.parametrize("rule", ["exact", "nearest", "compat"])
def test_msda_kernel_at_rule_positions_full_width(rule):
    g = torch.Generator(device="cuda").manual_seed(22)
    _, levels, B, _ = RULE_SHAPES["serving_cross"]
    pos, hint = _rule_positions(rule, g, "serving_cross", True)
    Nq = pos.shape[1]
    value = _randn(g, B, sum(a * b for a, b in levels), 8, 64)
    w = _randn(g, B, Nq, 8, 32).softmax(-1).view(B, Nq, 8, 4, 8)
    want = msda_ops.msda_plain(value, levels, pos, w)
    for window in ((hint if rule == "compat" else ()), ()):
        torch.testing.assert_close(
            msda_ops.msda(value, levels, pos, w, *window), want, rtol=2e-4,
            atol=2e-5)


@pytest.mark.parametrize("sampling", ["bilinear", "nearest",
                                      "windowed_compat"])
def test_neck_modes_launch_the_kernels_under_autograd(sampling):
    """Every sampling mode of the neck goes through kernel B, and kernel C
    under autograd, on CUDA tensors; its gradients equal those of the plain
    versions (nearest: zero for the offsets and the reference points)."""
    import contextlib
    from unittest import mock

    from gedepth_tpu_torch.models.hahi import HAHINeck
    from gedepth_tpu_torch.models.layers import init_weights

    chans = (16, 24, 32, 40, 48)
    grids = ((32, 64), (16, 32), (8, 16), (4, 8), (2, 4))
    neck = HAHINeck(chans, chans, embed_dim=64, num_heads=2, num_points=4,
                    sampling=sampling, window_radius=6)
    init_weights(neck, torch.Generator().manual_seed(0))
    with torch.no_grad():     # offsets that depend on the query
        for att in (neck.self_attn, neck.multi_att):
            att.sampling_offsets.weight.normal_(0, 0.3)
    neck = neck.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(23)
    feats = [_randn(g, 2, c, h_, w_) for (h_, w_), c in zip(grids, chans)]

    def grads(plain):
        neck.zero_grad()
        ctx = (mock.patch.object(
            msda_ops, "msda", lambda v, s, p, w_, *hint: msda_ops.msda_plain(
                v, s, p, w_)) if plain else contextlib.nullcontext())
        with ctx:
            sum(o.square().sum() for o in neck(feats)).backward()
        return {n: p.grad.clone() for n, p in neck.named_parameters()}

    before = msda_ops.msda.launches, msda_ops.msda_backward.launches
    got = grads(plain=False)
    torch.cuda.synchronize()
    assert (msda_ops.msda.launches, msda_ops.msda_backward.launches) == (
        before[0] + 2, before[1] + 2)
    want = grads(plain=True)
    assert (msda_ops.msda.launches, msda_ops.msda_backward.launches) == (
        before[0] + 2, before[1] + 2)
    for name, w_ in want.items():
        torch.testing.assert_close(got[name], w_, rtol=2e-3,
                                   atol=1e-4 * w_.abs().max().item() + 1e-9,
                                   msg=lambda m, name=name: f"{name}: {m}")
    moved = got["multi_att.sampling_offsets.weight"].abs().sum().item()
    assert (moved == 0) == (sampling == "nearest")
    assert (got["reference_points.weight"].abs().sum().item() == 0) == (
        sampling == "nearest")


# ---- the bf16 instances of A, B and C --------------------------------
#
# A bf16 kernel takes bf16 in, computes in f32 and rounds once; its plain
# version rounds alike but not bit for bit, so both are held to a float64
# evaluation of the same bf16 inputs: the kernel's largest error is at most
# max(2 x the plain version's, one bf16 ulp at the output's largest
# magnitude; for kernel C's f32 outputs 1e-5 of theirs).

BF16 = torch.bfloat16


def _bf16_ulp(x):
    return 2.0 ** (int(np.floor(np.log2(max(x, 1e-30)))) - 7)


def _assert_close_to_f64(got, plain, ref, floor=None):
    ref = ref.double()
    err = (got.double() - ref).abs().max().item()
    plain_err = (plain.double() - ref).abs().max().item()
    if floor is None:
        floor = _bf16_ulp(ref.abs().max().item())
    assert bool(torch.isfinite(got).all())
    assert err <= max(2 * plain_err, floor), (err, plain_err, floor)


@pytest.mark.parametrize("bias_dtype", [BF16, torch.float32])
@pytest.mark.parametrize("nWB,N,H,D,grid", [
    (572, 49, 6, 32, (91, 308)), (676, 49, 6, 32, (91, 182)),
    (44, 49, 24, 32, (28, 77)), (12, 49, 48, 32, None),
    # N != 49, D in {8, 64} and widths that are not multiples of 16
    (12, 36, 4, 32, (12, 18)), (10, 9, 3, 64, None), (10, 64, 3, 64, None),
    (7, 33, 2, 8, None), (16, 49, 2, 24, (14, 28)), (5, 16, 2, 56, None)])
def test_window_attention_bf16_kernel(nWB, N, H, D, grid, bias_dtype):
    g = torch.Generator(device="cuda").manual_seed(20)
    qkv = _randn(g, nWB, N, 3, H, D).to(BF16)
    q, k, v = qkv[:, :, 0] * D ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
    assert not k.is_contiguous()
    bias = _randn(g, H, N, N).to(bias_dtype)
    mask = None
    if grid is not None:
        win = int(round(N ** 0.5))
        mask = torch.as_tensor(shifted_window_mask(*grid, win, win // 2),
                               device="cuda")
    before = wa.window_attention.launches_by_dtype[BF16]
    got = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    assert wa.window_attention.launches_by_dtype[BF16] == before + 1
    ref = wa.window_attention_plain(
        *(t.double() for t in (q, k, v, bias)),
        None if mask is None else mask.double())
    _assert_close_to_f64(got, wa.window_attention_plain(q, k, v, bias, mask),
                         ref)
    if mask is not None:        # a bf16 mask (0 / -100 are exact) too
        again = wa.window_attention(q, k, v, bias, mask.to(BF16))
        assert torch.equal(again, got)


def test_window_attention_bf16_kernel_large_logits():
    g = torch.Generator(device="cuda").manual_seed(21)
    qkv = (_randn(g, 44, 49, 3, 24, 32) * 16.0).to(BF16)
    q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2] / 16.0
    bias = _randn(g, 24, 49, 49).to(BF16)
    mask = torch.as_tensor(shifted_window_mask(28, 77, 7, 3), device="cuda")
    got = wa.window_attention(q, k, v.contiguous(), bias, mask)
    ref = wa.window_attention_plain(
        *(t.double() for t in (q, k, v, bias, mask)))
    _assert_close_to_f64(got, wa.window_attention_plain(q, k, v, bias, mask),
                         ref)


@pytest.mark.parametrize("case", [
    "mixed_qk", "float16_bias", "row_stride", "misaligned", "f32_q_bf16_bias"])
def test_window_attention_bf16_kernel_refuses(case):
    """What the bf16 instance does not take raises and launches nothing:
    no cast to f32 around the f32 kernel, no plain version."""
    nWB, N, H, D = 4, 49, 2, 32
    g = torch.Generator(device="cuda").manual_seed(22)
    qkv = _randn(g, nWB, N, 3, H, D).to(BF16)
    q, k, v = qkv[:, :, 0] * D ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
    bias = _randn(g, H, N, N).to(BF16)
    row, error = H * D, ValueError
    base = torch.zeros(4096 * 64, device="cuda", dtype=BF16)
    if case == "mixed_qk":
        k, error = k.float(), TypeError
    elif case == "float16_bias":
        bias, error = bias.to(torch.float16), TypeError
    elif case == "f32_q_bf16_bias":
        q, k, v, error = q.float(), k.float(), v.float(), TypeError
    elif case == "row_stride":       # rows 4 elements apart from 16 bytes
        v = base.as_strided((nWB, N, H, D), (N * (row + 4), row + 4, D, 1))
    elif case == "misaligned":       # 8 bytes into a 16-byte unit
        q = base.as_strided((nWB, N, H, D), (N * row, row, D, 1), 4)
    before = wa.window_attention.launches
    with pytest.raises(error):
        wa.window_attention(q, k, v, bias, None)
    assert wa.window_attention.launches == before


def test_window_attention_bf16_gradients_in_input_dtypes():
    g = torch.Generator(device="cuda").manual_seed(23)
    qkv = _randn(g, 8, 49, 3, 2, 32).to(BF16).requires_grad_()
    bias = _randn(g, 2, 49, 49).to(BF16).requires_grad_()
    out = wa.window_attention(qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1],
                              qkv[:, :, 2], bias)
    out.float().square().sum().backward()
    assert qkv.grad.dtype == BF16 and bias.grad.dtype == BF16
    assert bool(torch.isfinite(qkv.grad).all()) and qkv.grad.abs().sum() > 0


def _bf16_msda_case(g, query_shapes, levels, B, h, d, P, spread, far):
    Nq = sum(a * b for a, b in query_shapes)
    S = sum(a * b for a, b in levels)
    value = _randn(g, B, S, h, d).to(BF16)
    pos = msda_ops.windowed_positions(
        spread * _randn(g, B, Nq, h, len(levels), P, 2), query_shapes,
        levels, 4)
    if far:     # a tenth of the samples out of their windows and levels
        kick = _randn(g, *pos.shape) * torch.where(
            torch.rand(pos.shape[:-1], generator=g, device="cuda") < 0.1,
            1e6, 60.0)[..., None]
        pos = pos + kick * (torch.rand(pos.shape[:-1], generator=g,
                                       device="cuda") < 0.1)[..., None]
    w = _randn(g, B, Nq, h, len(levels) * P).softmax(-1).view(
        B, Nq, h, len(levels), P)
    return value, pos, w, _randn(g, B, Nq, h * d).to(BF16)


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("query_shapes,levels,B,h,d", [
    (((5, 13),), ((10, 26), (5, 13)), 2, 2, 24),      # d % 8 == 0, lanes idle
    (((3, 5),), ((12, 20),), 1, 2, 64),               # one level
    (((6, 10),), ((12, 20), (6, 10)), 1, 3, 12),      # d % 8 != 0: scalar
    (((4, 6),), ((8, 12), (4, 6)), 1, 2, 7),          # odd head width
    (((44, 88), (22, 44), (11, 22)),
     ((88, 176), (44, 88), (22, 44), (11, 22)), 2, 8, 64),
    (((176, 352),), ((88, 176), (44, 88), (22, 44), (11, 22)), 1, 8, 64)])
def test_msda_bf16_kernels(query_shapes, levels, B, h, d, far):
    """B and C on a bf16 value, with the hint and without, against float64
    of the same inputs; gradients in their inputs' dtypes."""
    g = torch.Generator(device="cuda").manual_seed(24)
    value, pos, w, gout = _bf16_msda_case(g, query_shapes, levels, B, h, d,
                                          4, 2.0, far)
    ref = msda_ops.msda_plain(value.double(), levels, pos.double(),
                              w.double())
    plain = msda_ops.msda_plain(value, levels, pos, w)
    ref_b = msda_ops.msda_backward_plain(value.double(), levels, pos.double(),
                                         w.double(), gout.double())
    plain_b = msda_ops.msda_backward_plain(value, levels, pos, w, gout)
    for hint in ((query_shapes, 4), ()):
        before = (msda_ops.msda.launches_by_dtype[BF16],
                  msda_ops.msda_backward.launches_by_dtype[BF16])
        got = msda_ops.msda(value, levels, pos, w, *hint)
        got_b = msda_ops.msda_backward(value, levels, pos, w, gout, *hint)
        torch.cuda.synchronize()
        assert (msda_ops.msda.launches_by_dtype[BF16],
                msda_ops.msda_backward.launches_by_dtype[BF16]) == (
                    before[0] + 1, before[1] + 1)
        assert got.dtype == BF16
        assert [t.dtype for t in got_b] == [BF16, torch.float32,
                                            torch.float32]
        _assert_close_to_f64(got, plain, ref)
        _assert_close_to_f64(got_b[0], plain_b[0], ref_b[0])
        for i in (1, 2):
            _assert_close_to_f64(got_b[i], plain_b[i], ref_b[i],
                                 floor=1e-5 * ref_b[i].abs().max().item())


def test_msda_bf16_unaligned_value_takes_the_scalar_instance():
    g = torch.Generator(device="cuda").manual_seed(25)
    levels, grids = ((8, 12), (4, 6)), ((4, 6),)
    value, pos, w, _ = _bf16_msda_case(g, grids, levels, 1, 2, 64, 4, 2.0,
                                       False)
    shifted = torch.empty(value.numel() + 1, device="cuda", dtype=BF16)[1:]
    shifted = shifted.view(value.shape).copy_(value)
    assert shifted.data_ptr() % 16 == 2
    assert torch.equal(msda_ops.msda(shifted, levels, pos, w, grids, 4),
                       msda_ops.msda(value, levels, pos, w, grids, 4))


@pytest.mark.parametrize("case", ["pos_bf16", "weights_bf16", "gout_f32",
                                  "value_f16"])
def test_msda_bf16_kernels_refuse(case):
    """pos and weights are f32 at the kernels' boundary and grad_out has the
    value's dtype; anything else raises and launches nothing."""
    g = torch.Generator(device="cuda").manual_seed(26)
    levels, grids = ((4, 6),), ((4, 6),)
    value, pos, w, gout = _bf16_msda_case(g, grids, levels, 1, 2, 8, 2, 1.0,
                                          False)
    if case == "pos_bf16":
        pos = pos.to(BF16)
    elif case == "weights_bf16":
        w = w.to(BF16)
    elif case == "gout_f32":
        gout = gout.float()
    elif case == "value_f16":
        value, gout = value.to(torch.float16), gout.to(torch.float16)
    before = msda_ops.msda.launches, msda_ops.msda_backward.launches
    if case != "gout_f32":
        with pytest.raises(TypeError):
            msda_ops.msda(value, levels, pos, w, grids, 4)
    with pytest.raises(TypeError):
        msda_ops.msda_backward(value, levels, pos, w, gout, grids, 4)
    assert before == (msda_ops.msda.launches, msda_ops.msda_backward.launches)


def test_msda_bf16_autograd_uses_the_bf16_kernels():
    g = torch.Generator(device="cuda").manual_seed(27)
    levels, grids = ((8, 12), (4, 6)), ((8, 12), (4, 6))
    value, pos, w, gout = _bf16_msda_case(g, grids, levels, 2, 2, 32, 4, 2.0,
                                          False)
    value, pos, w = (t.requires_grad_() for t in (value, pos, w))
    before = msda_ops.msda_backward.launches_by_dtype[BF16]
    out = msda_ops.msda(value, levels, pos, w, grids, 4)
    out.backward(gout)
    assert msda_ops.msda_backward.launches_by_dtype[BF16] == before + 1
    assert value.grad.dtype == BF16 and pos.grad.dtype == torch.float32 \
        and w.grad.dtype == torch.float32
    want = msda_ops.msda_backward_plain(value.detach(), levels, pos.detach(),
                                        w.detach(), gout)
    torch.testing.assert_close(pos.grad, want[1], rtol=2e-4, atol=2e-5)


def test_pe_fusion_lifts_bf16_inputs_around_the_f32_kernel():
    g = torch.Generator(device="cuda").manual_seed(28)
    logits = _randn(g, 1, 64, 128, 11).to(BF16)
    pe = (torch.rand(1, 64, 128, generator=g, device="cuda") * 78 + 2).to(BF16)
    y = torch.rand(1, 64, 128, generator=g, device="cuda").to(BF16)
    cam = torch.full((1,), 1.65, device="cuda", dtype=BF16)
    before = pe_ops.pe_fusion.launches
    got = pe_ops.pe_fusion(logits, pe, y, cam, 200.0)
    assert got.dtype == BF16 and pe_ops.pe_fusion.launches == before + 1
    want = pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    with pytest.raises(TypeError):
        pe_ops.pe_fusion(logits, pe.float(), y, cam, 200.0)


# ---- checkpoints written on the card ----------------------------------

def _smoke_cfg():
    """smoke_synthetic on 64x128 frames, 2 test images, no flip-TTA."""
    import dataclasses

    from gedepth_tpu_torch.configs import get_config

    cfg = get_config("smoke_synthetic")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, crop_size=(64, 128), eval_size=(64, 128), synthetic_size=8,
        eval_flip_tta=False))


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k].cpu(), sb[k].cpu()), k
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        for name, t in oa[i].items():
            assert torch.equal(t.cpu(), ob[i][name].cpu()), (i, name)


@pytest.mark.parametrize("restore_on", ["cuda", "cpu"])
def test_card_checkpoint_restores_bit_equal(tmp_path, restore_on):
    """A checkpoint that train() wrote on the card restores bit for bit
    into a fresh state on the card, and into one on the CPU (the tensors
    follow the state's device); training then resumes on that device."""
    from gedepth_tpu_torch.train.checkpoint import restore_checkpoint
    from gedepth_tpu_torch.train.loop import train
    from gedepth_tpu_torch.train.steps import create_train_state

    cfg = _smoke_cfg()
    state, _, _ = train(cfg, work_dir=str(tmp_path), max_iters=2,
                        eval_max_images=1, device="cuda")
    fresh = create_train_state(
        cfg.model.build(device=restore_on,
                        generator=torch.Generator().manual_seed(5)),
        cfg.optim, 2)
    restore_checkpoint(str(tmp_path / "ckpts"), fresh)
    assert next(fresh.model.parameters()).device.type == restore_on
    assert all(t.device.type == restore_on
               for st in fresh.optimizer.state.values()
               for n, t in st.items() if n != "step")
    _assert_same_state(state, fresh)
    resumed, history, _ = train(cfg, max_iters=3, eval_max_images=1,
                                resume_from=str(tmp_path / "ckpts"),
                                device=restore_on)
    assert resumed.step == 3 and next(
        resumed.model.parameters()).device.type == restore_on
    assert [(r["mode"], r["iter"]) for r in history] == [("train", 3),
                                                         ("val", 3)]
