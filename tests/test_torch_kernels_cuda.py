"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); every test here is marked `cuda`
and skips elsewhere. This file imports no JAX, and tests/conftest.py does,
so on a machine without JAX run it with:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances (f32, TF32 off): window attention and deformable sampling rtol
2e-4, atol 2e-5 (sums in another order, the kernel's exp against torch's);
PE fusion 1e-4, as on the CPU. The deformable-sampling backward (kernel C)
holds d_pos and d_weights to rtol 2e-4, atol 2e-5, and d_value, which its
atomics sum in any order, to rtol 2e-4 plus atol 1e-5·max|d_value|.
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
    got = grads(msda_ops.msda)
    torch.cuda.synchronize()
    assert msda_ops.msda.launches == fwd0 + 1
    assert msda_ops.msda_backward.launches == bwd0 + 1
    want = grads(msda_ops.msda_plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4,
                                   atol=1e-5 * b.abs().max().item())
