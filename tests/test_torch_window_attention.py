"""Window attention of the PyTorch port against the JAX package.

`window_attention` on CPU tensors runs its plain version (the einsum of
`window_attention_xla`); `WindowMSA` and a shifted, padded `SwinBlock` take
their weights from a flax variable tree through `state_dict_from_flax`.
Inputs come from seeded numpy on both sides. Tolerance: rtol 1e-4,
atol 1e-5, the torch-parity tolerance of tests/test_parity_torch.py (f32 on
both sides, sums in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models.swin import SwinBlock as JaxSwinBlock
from gedepth_tpu.models.swin import WindowMSA as JaxWindowMSA
from gedepth_tpu.ops.window_attention import window_attention_xla
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models.swin import (
    SwinBlock, WindowMSA, shifted_window_mask)
from gedepth_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)


def _random_params(init_fn, *args, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return 1 + rng.normal(0, 0.1, s.shape)
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return rng.normal(0, 0.5, s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _sub_state_dict(params, prefix):
    """Carry a block's flax params over under its Swin-L key prefix."""
    sd = state_dict_from_flax({"backbone": {"stage0_block0": params}})
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("nW", [None, 6])
def test_window_attention_matches_xla(nW):
    rng = np.random.default_rng(0)
    nWB, N, H, D = 12, 49, 3, 32
    q, k, v = (rng.standard_normal((nWB, N, H, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = None
    if nW is not None:
        mask = np.where(rng.random((nW, N, N)) > 0.5, 0.0,
                        -100.0).astype(np.float32)
    want = np.asarray(window_attention_xla(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask)))
    before = wa.window_attention.launches
    got = wa.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    assert wa.window_attention.launches == before   # CPU: no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_window_attention_checks_shapes():
    q = torch.zeros(4, 49, 2, 8)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros(2, 49, 48))
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros(2, 49, 49),
                            torch.zeros(3, 49, 49))


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_msa_matches_flax(with_mask):
    rng = np.random.default_rng(1)
    C, heads, window, nWB = 48, 2, 7, 8
    x = rng.standard_normal((nWB, window * window, C)).astype(np.float32)
    mask = shifted_window_mask(14, 28, window, 3) if with_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    jm = JaxWindowMSA(embed_dims=C, num_heads=heads, window=window)
    params = _random_params(jm.init, jnp.asarray(x), jmask, seed=2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jmask))

    tm = WindowMSA(C, heads, window).eval()
    tm.load_state_dict(_sub_state_dict(
        {"attn": params}, "backbone.stages.0.blocks.0.attn.w_msa."),
        strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shift,hw", [(True, (10, 17)), (True, (14, 21)),
                                      (False, (9, 11))])
def test_swin_block_matches_flax(shift, hw):
    """Pad to multiples of 7 before the roll, mask on the padded size."""
    rng = np.random.default_rng(3)
    C, heads = 48, 2
    x = rng.standard_normal((2, hw[0] * hw[1], C)).astype(np.float32)
    jm = JaxSwinBlock(C, heads, 7, shift=shift)
    params = _random_params(lambda key, x_: jm.init(key, x_, hw),
                            jnp.asarray(x), seed=4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), hw))

    tm = SwinBlock(C, heads, 7, shift=shift).eval()
    tm.load_state_dict(_sub_state_dict(
        params, "backbone.stages.0.blocks.0."), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_masks_and_index_match_jax():
    from gedepth_tpu.models import swin as jswin
    from gedepth_tpu_torch.models import swin as tswin

    for args in ((14, 28, 7, 3), (21, 14, 7, 3), (7, 7, 7, 3)):
        np.testing.assert_array_equal(tswin.shifted_window_mask(*args),
                                      jswin.shifted_window_mask(*args))
    np.testing.assert_array_equal(tswin.relative_position_index(7, 7),
                                  jswin.relative_position_index(7, 7))


def _attention_inputs(nW, seed=5):
    rng = np.random.default_rng(seed)
    nWB, N, H, D = 12, 49, 3, 32
    q, k, v = (rng.standard_normal((nWB, N, H, D)).astype(np.float32)
               for _ in range(3))
    q = (q * D ** -0.5).astype(np.float32)      # pre-scaled, as WindowMSA
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = None
    if nW is not None:
        mask = np.where(rng.random((nW, N, N)) > 0.5, 0.0,
                        -100.0).astype(np.float32)
    cot = rng.standard_normal((nWB, N, H, D)).astype(np.float32)
    return (q, k, v, bias), mask, cot


def _torch_grads(fn, arrays, mask, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    (fn(*leaves, m) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("nW", [None, 6])
def test_window_attention_grads_match_xla(nW):
    """d_q, d_k, d_v and d_bias of the port against jax.grad of
    `window_attention_xla`, the function the JAX package's custom VJP
    differentiates."""
    arrays, mask, cot = _attention_inputs(nW)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax.grad(
        lambda q, k, v, b: jnp.sum(window_attention_xla(q, k, v, b, jmask)
                                   * cot), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    got = _torch_grads(wa.window_attention, arrays, mask, cot)
    for g, w_, name in zip(got, want, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _packed(fn):
    """fn over (qkv, bias): k and v as views into a packed (nWB, N, 3, H, D)
    qkv, q a scaled copy of its first slot, as `WindowMSA` passes them."""
    def run(qkv, bias, mask):
        return fn(qkv[:, :, 0] * 0.5, qkv[:, :, 1], qkv[:, :, 2], bias, mask)
    return run


@pytest.mark.parametrize("nW,packed", [
    pytest.param(None, False, id="None"), pytest.param(6, False, id="6"),
    pytest.param(None, True, id="None-packed"),
    pytest.param(6, True, id="6-packed")])
def test_window_attention_function_wiring(nW, packed):
    """`window_attention_op` (kernel A's op) on CPU tensors, where it runs
    the plain forward in place of the launch: its gradients through the
    registered backward equal autograd through the plain version, also
    through k and v that are views into a packed qkv."""
    arrays, mask, cot = _attention_inputs(nW, seed=6)
    fn, ref = wa.window_attention_op, wa.window_attention_plain
    if packed:
        arrays = (np.stack(arrays[:3], axis=2), arrays[3])
        fn, ref = _packed(fn), _packed(ref)
    got = _torch_grads(fn, arrays, mask, cot)
    want = _torch_grads(ref, arrays, mask, cot)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7)


def _strided(shape, strides, offset=0):
    return torch.zeros(offset + 4096 * 64).as_strided(shape, strides, offset)


@pytest.mark.parametrize("case", [
    "packed", "float64", "N65", "D20", "D72", "last_stride", "head_stride",
    "row_stride", "window_stride", "misaligned", "bias_strided"])
def test_kernel_input_check(case):
    """What kernel A takes, decided on tensor metadata alone: k and v as
    views into a packed qkv pass; each layout or type it cannot read
    raises (the wrapper runs this check before every launch)."""
    nWB, N, H, D = 4, 49, 2, 32
    qkv = torch.zeros(nWB, N, 3, H, D)
    q, k, v = qkv[:, :, 0] * 1.0, qkv[:, :, 1], qkv[:, :, 2]
    bias, mask = torch.zeros(H, N, N), torch.zeros(2, N, N)
    row = H * D
    bad = {
        "float64": lambda: dict(q=q.double()),
        "N65": lambda: dict(q=torch.zeros(nWB, 65, H, D)),
        "D20": lambda: dict(q=torch.zeros(nWB, N, H, 20)),
        "D72": lambda: dict(q=torch.zeros(nWB, N, H, 72)),
        "last_stride": lambda: dict(
            k=torch.zeros(nWB, N, D, H).transpose(2, 3)),
        "head_stride": lambda: dict(
            k=_strided((nWB, N, H, D), (N * 2 * row, 2 * row, 2 * D, 1))),
        "row_stride": lambda: dict(
            v=_strided((nWB, N, H, D), (N * (row + 1), row + 1, D, 1))),
        "window_stride": lambda: dict(
            v=_strided((nWB, N, H, D), (N * row + 2, row, D, 1))),
        "misaligned": lambda: dict(
            q=_strided((nWB, N, H, D), (N * row, row, D, 1), offset=1)),
        "bias_strided": lambda: dict(
            bias=torch.zeros(H, N, N).transpose(1, 2)),
    }
    args = dict(q=q, k=k, v=v, bias=bias, mask=mask)
    if case == "packed":
        wa.check_kernel_inputs(**args)
        return
    args.update(bad[case]())
    with pytest.raises(TypeError if case == "float64" else ValueError):
        wa.check_kernel_inputs(**args)
