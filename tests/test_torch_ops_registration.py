"""The port's kernels as dispatcher ops (`gedepth_torch::window_attention`,
`::msda`, `::msda_backward`, `::pe_fusion`) on CPU tensors, where each op
runs its kernel's plain version.

- `torch.library.opcheck` (schema, autograd registration, fake tensors
  against the real implementation, AOT dispatch with dynamic shapes) on
  tiny inputs, f32 and bf16, windowed and unbounded windows for B and C;
- the fake implementations' shapes, dtypes and strides equal the plain
  versions' (what `torch.export` traces is what runs);
- the ops' gradients equal autograd through the plain versions: the
  backwards of A and E are the plain versions' VJPs and C's CPU twin forms
  autograd's products and sums in autograd's order, so they agree to the
  bit; the test holds them to rtol 1e-6.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from gedepth_tpu_torch.ops import msda as msda_ops
from gedepth_tpu_torch.ops import pe_fusion as pe_ops
from gedepth_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)

BF16 = torch.bfloat16
LEVELS = ((6, 10), (3, 5))
GRIDS = ((3, 5),)
RADIUS = 4.0


def _attention(dtype, masked, seed=0, device="cpu"):
    """(q, k, v, bias, mask): k and v views into a packed qkv, as the model
    passes them; bf16 bias with an f32 mask, as a bf16 model holds them."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(4, 9, 3, 2, 8, generator=g).to(device, dtype)
    q, k, v = qkv[:, :, 0] * 0.5, qkv[:, :, 1], qkv[:, :, 2]
    bias = torch.randn(2, 9, 9, generator=g).to(device, dtype)
    mask = (torch.randn(2, 9, 9, generator=g).to(device) if masked
            else None)
    return q, k, v, bias, mask


def _sampling(dtype, windowed, seed=0, device="cpu"):
    """(value, pos, weights, grad_out, window args) for 15 queries on the
    3x5 grid over two levels; positions by the windowed rule, or spread
    over and past the levels when unbounded."""
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(1, 75, 2, 8, generator=g).to(dtype)
    raw = torch.randn(1, 15, 2, 2, 3, 2, generator=g) * 3
    if windowed:
        pos = msda_ops.windowed_positions(raw, GRIDS, LEVELS, RADIUS)
        window = ([3, 5], RADIUS)
    else:
        pos = raw * 2 + 4
        window = ([], None)
    weights = torch.rand(1, 15, 2, 2, 3, generator=g)
    grad_out = torch.randn(1, 15, 16, generator=g).to(dtype)
    return (value.to(device), pos.contiguous().to(device),
            weights.to(device), grad_out.to(device), window)


def _fusion(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 4, 6, 11, generator=g).to(device),
            (torch.rand(2, 4, 6, generator=g) * 60 + 1).to(device),
            torch.rand(2, 4, 6, generator=g).to(device),
            torch.tensor([1.65, 1.52], device=device), 200.0)


def _op_case(name, device="cpu"):
    """(op, args) of one case name `op-dtype-variant`, on `device`."""
    op, dtype, variant = name.split("-")
    dtype = {"f32": torch.float32, "bf16": BF16}[dtype]
    if op == "window_attention":
        return wa.window_attention_op, _attention(
            dtype, variant == "mask", device=device)
    if op == "pe_fusion":
        return pe_ops.pe_fusion_op, _fusion(device=device)
    value, pos, weights, grad_out, (grids, radius) = _sampling(
        dtype, variant == "windowed", device=device)
    levels = [v for hw in LEVELS for v in hw]
    if op == "msda":
        return msda_ops.msda_op, (value, levels, pos, weights, grids, radius)
    return msda_ops.msda_backward_op, (value, levels, pos, weights, grad_out,
                                       grids, radius)


CASES = ([f"window_attention-{t}-{m}" for t in ("f32", "bf16")
          for m in ("mask", "nomask")]
         + [f"{op}-{t}-{w}" for op in ("msda", "msda_backward")
            for t in ("f32", "bf16") for w in ("windowed", "unbounded")]
         + ["pe_fusion-f32-plain"])


def _plain(name, args):
    """The plain version's output of a case."""
    op = name.split("-")[0]
    if op == "window_attention":
        return wa.window_attention_plain(*args)
    if op == "pe_fusion":
        return pe_ops.pe_fusion_plain(*args)
    value, levels, pos, weights = args[:4]
    shapes = tuple(zip(levels[::2], levels[1::2]))
    if op == "msda":
        return msda_ops.msda_plain(value, shapes, pos, weights)
    return msda_ops.msda_backward_plain(value, shapes, pos, weights, args[4])


def test_ops_are_registered():
    """The four ops under one namespace, with the schemas the port's
    wrappers call."""
    ops = torch.ops.gedepth_torch
    schemas = {name: str(getattr(ops, name).default._schema)
               for name in ("window_attention", "msda", "msda_backward",
                            "pe_fusion")}
    assert schemas["window_attention"].endswith(
        "(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask) -> Tensor")
    assert "int[] spatial_shapes" in schemas["msda"]
    assert "float? window_radius" in schemas["msda_backward"]
    assert schemas["msda_backward"].endswith("-> (Tensor, Tensor, Tensor)")
    assert "float depth_scale" in schemas["pe_fusion"]


# the inputs each op differentiates (msda_backward: none)
DIFFERENTIABLE = {"window_attention": (0, 1, 2, 3), "msda": (0, 2, 3),
                  "msda_backward": (), "pe_fusion": (0, 2)}


@pytest.mark.parametrize("name", CASES)
def test_opcheck(name):
    op, args = _op_case(name)
    wanted = DIFFERENTIABLE[name.split("-")[0]]
    args = tuple(a.detach().requires_grad_() if i in wanted else a
                 for i, a in enumerate(args))
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", CASES)
def test_fake_matches_plain(name):
    """The fake implementation's outputs have the plain version's shapes,
    dtypes and strides."""
    op, args = _op_case(name)
    want = _plain(name, args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    want = want if isinstance(want, tuple) else (want,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in want]
    real = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    assert [t.stride() for t in fake] == [t.stride() for t in real]
    if name.startswith("msda_backward"):
        # d_value in the value's dtype, d_pos and d_weights in f32
        assert [t.dtype for t in fake] == [args[0].dtype, torch.float32,
                                           torch.float32]


def _grads(fn, inputs, cot):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    torch.autograd.backward(out, cot)
    return [t.grad for t in leaves]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [True, False])
def test_window_attention_op_grads_equal_plain(dtype, masked):
    dtype = {"f32": torch.float32, "bf16": BF16}[dtype]
    q, k, v, bias, mask = _attention(dtype, masked, seed=1)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    cot = cot.to(dtype)
    got = _grads(lambda *t: wa.window_attention_op(*t, mask), (q, k, v, bias),
                 cot)
    want = _grads(lambda *t: wa.window_attention_plain(*t, mask),
                  (q, k, v, bias), cot)
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("windowed", [True, False])
def test_msda_op_grads_equal_plain(dtype, windowed):
    """Through `msda` (the wrapper, its op and the backward op) against
    autograd through `msda_plain`: d_value, d_pos and d_weights."""
    dtype = {"f32": torch.float32, "bf16": BF16}[dtype]
    value, pos, weights, grad_out, (grids, radius) = _sampling(
        dtype, windowed, seed=2)
    hint = ((GRIDS, RADIUS) if windowed else ())
    got = _grads(lambda v, p, w: msda_ops.msda(v, LEVELS, p, w, *hint),
                 (value, pos, weights), grad_out)
    want = _grads(lambda v, p, w: msda_ops.msda_plain(v, LEVELS, p, w),
                  (value, pos, weights), grad_out)
    _assert_same(got, want)


def test_msda_backward_plain_chunks_equal_autograd(monkeypatch):
    """C's CPU twin over several query chunks (3 of 6 queries) and three
    levels, one sample of which lies on a level's far edge: the same bits as
    autograd through `msda_plain`, which chunks alike."""
    monkeypatch.setattr(msda_ops, "PLAIN_QUERY_CHUNK", 6)
    g = torch.Generator().manual_seed(7)
    levels = ((5, 7), (3, 4), (1, 2))
    value = torch.randn(2, 49, 2, 4, generator=g)
    pos = torch.rand(2, 16, 2, 3, 2, 2, generator=g) * 8 - 1.5
    pos[0, 0, 0, 0, 0] = torch.tensor([6.0, 4.0])
    weights = torch.rand(2, 16, 2, 3, 2, generator=g)
    cot = torch.randn(2, 16, 8, generator=g)
    want = _grads(lambda v, p, w: msda_ops.msda_plain(v, levels, p, w),
                  (value, pos, weights), cot)
    got = msda_ops.msda_backward_plain(value, levels, pos, weights, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pe_fusion_op_grads_equal_plain():
    logits, pe, y, h, scale = _fusion(seed=3)
    cot = torch.randn(pe.shape, generator=torch.Generator().manual_seed(6))
    got = _grads(lambda lg, y_: pe_ops.pe_fusion_op(lg, pe, y_, h, scale),
                 (logits, y), cot)
    want = _grads(lambda lg, y_: pe_ops.pe_fusion_plain(lg, pe, y_, h, scale),
                  (logits, y), cot)
    _assert_same(got, want)


def test_pe_fusion_bf16_through_the_f32_op():
    """E's op is f32, as kernel E: the wrapper lifts bf16 inputs and rounds
    the result once, as the plain version does; the op itself refuses
    bf16."""
    logits, pe, y, h, scale = _fusion(seed=4)
    args = [t.to(BF16) for t in (logits, pe, y, h)]
    got = pe_ops.pe_fusion(*args, scale)
    assert got.dtype == BF16
    assert torch.equal(got, pe_ops.pe_fusion_plain(*args, scale))
    with pytest.raises(TypeError, match="f32"):
        pe_ops.pe_fusion_op(*args, scale)


def test_ops_on_cpu_count_no_launch():
    """On CPU tensors the ops run the plain versions and count no kernel
    launch."""
    before = (wa.window_attention.launches, msda_ops.msda.launches,
              msda_ops.msda_backward.launches, pe_ops.pe_fusion.launches)
    for name in ("window_attention-f32-mask", "msda-f32-windowed",
                 "msda_backward-f32-windowed", "pe_fusion-f32-plain"):
        op, args = _op_case(name)
        op(*args)
    assert (wa.window_attention.launches, msda_ops.msda.launches,
            msda_ops.msda_backward.launches,
            pe_ops.pe_fusion.launches) == before
