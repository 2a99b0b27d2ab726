"""Adaptive PE fusion and the PE necks of the PyTorch port against JAX.

`pe_fusion` on CPU tensors runs its plain version (the math of
`pe_fusion_xla`). PE inputs stay off the validity edges 0 and depth_scale,
as tests/test_pallas_kernels.py does, because a prior on the edge flips
between valid and zero on a rounding. Tolerance 1e-4 (rtol and atol), the
PE-fusion tolerance of tests/test_pallas_kernels.py: off = h/(h/pe + t)
amplifies a rounding of the slope t by off²/h. The necks hold the
torch-parity tolerance rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models.necks import DynamicPENeckSoft as JaxDynamic
from gedepth_tpu.models.necks import LightPEMaskNeck as JaxLight
from gedepth_tpu.ops.pallas.pe_fusion import pe_fusion_xla
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models.necks import DynamicPENeckSoft, LightPEMaskNeck
from gedepth_tpu_torch.ops import pe_fusion as pe_ops

torch.set_num_threads(1)


def test_pe_fusion_matches_xla():
    rng = np.random.default_rng(1)
    B, H, W = 2, 32, 128
    logits = rng.standard_normal((B, H, W, 11)).astype(np.float32)
    pe = (np.abs(rng.standard_normal((B, H, W))) * 50 + 0.5).astype(
        np.float32)
    y = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    h = np.asarray([1.65, 1.55], np.float32)
    want = np.asarray(pe_fusion_xla(*(jnp.asarray(a)
                                      for a in (logits, pe, y, h)), 200.0))
    before = pe_ops.pe_fusion.launches
    got = pe_ops.pe_fusion(*(torch.from_numpy(a)
                             for a in (logits, pe, y, h)), 200.0)
    assert pe_ops.pe_fusion.launches == before   # CPU: no kernel
    assert (want == 0).any() and (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_pe_fusion_checks_shapes():
    with pytest.raises(ValueError):
        pe_ops.pe_fusion(torch.zeros(1, 4, 4, 10), torch.zeros(1, 4, 4),
                         torch.zeros(1, 4, 4), torch.ones(1), 200.0)
    with pytest.raises(ValueError):
        pe_ops.pe_fusion(torch.zeros(1, 4, 4, 11), torch.zeros(1, 4, 5),
                         torch.zeros(1, 4, 4), torch.ones(1), 200.0)


def test_slope_to_pe_offset_matches_jax():
    from gedepth_tpu.geometry import plane as jplane
    from gedepth_tpu_torch.geometry import plane as tplane

    rng = np.random.default_rng(2)
    pe = rng.uniform(-50, 250, (64,)).astype(np.float32)
    t = rng.uniform(-0.09, 0.09, (64,)).astype(np.float32)
    want, wvalid = jplane.slope_to_pe_offset(pe, t, np.float32(1.65), 200.0)
    got, gvalid = tplane.slope_to_pe_offset(
        torch.from_numpy(pe), torch.from_numpy(t), torch.tensor(1.65), 200.0)
    np.testing.assert_array_equal(gvalid.numpy(), wvalid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    raw = np.array([np.inf, -np.inf, np.nan, 3e6, 12.0, -4.0, 250.0])
    np.testing.assert_array_equal(tplane.sanitize_pe_raw(raw),
                                  jplane.sanitize_pe_raw(raw))
    np.testing.assert_array_equal(tplane.clip_pe_for_input(raw),
                                  jplane.clip_pe_for_input(raw))
    np.testing.assert_array_equal(tplane.SLOPE_BIN_CENTERS_DEG,
                                  jplane.SLOPE_BIN_CENTERS_DEG)


@pytest.mark.parametrize("name", ["pe_mask_neck", "dynamic_pe_neck"])
def test_pe_necks_match_flax(name):
    rng = np.random.default_rng(3)
    chans = (16, 24, 32, 40, 48)
    grids = ((32, 64), (16, 32), (8, 16), (4, 8), (2, 4))
    feats = [rng.standard_normal((1, h_, w_, c)).astype(np.float32)
             for (h_, w_), c in zip(grids, chans)]
    jm = JaxLight() if name == "pe_mask_neck" else JaxDynamic()
    args = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x),
                            jax.random.PRNGKey(0), args)["params"]
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)
    want = jm.apply({"params": params}, args)

    tm = (LightPEMaskNeck(chans) if name == "pe_mask_neck"
          else DynamicPENeckSoft(chans)).eval()
    sd = state_dict_from_flax({name: params})
    tm.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    if name == "pe_mask_neck":
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w_ in pairs:
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w_), rtol=1e-4, atol=1e-5)


def _fusion_inputs(seed=4):
    rng = np.random.default_rng(seed)
    B, H, W = 2, 16, 32
    logits = rng.standard_normal((B, H, W, 11)).astype(np.float32)
    pe = (np.abs(rng.standard_normal((B, H, W))) * 50 + 0.5).astype(
        np.float32)
    y = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    h = np.asarray([1.65, 1.55], np.float32)
    cot = rng.standard_normal((B, H, W)).astype(np.float32)
    return logits, pe, y, h, cot


def _torch_fusion_grads(fn, logits, pe, y, h, cot):
    lg = torch.from_numpy(logits).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = fn(lg, torch.from_numpy(pe), yt, torch.from_numpy(h), 200.0)
    (out * torch.from_numpy(cot)).sum().backward()
    return lg.grad.numpy(), yt.grad.numpy()


def test_pe_fusion_grads_match_xla():
    """d_logits and d_y of the port against jax.grad of `pe_fusion_xla`,
    the function the JAX package's custom VJP differentiates."""
    logits, pe, y, h, cot = _fusion_inputs()
    want = jax.grad(
        lambda l, y_: jnp.sum(pe_fusion_xla(l, jnp.asarray(pe), y_,
                                            jnp.asarray(h), 200.0) * cot),
        argnums=(0, 1))(jnp.asarray(logits), jnp.asarray(y))
    got = _torch_fusion_grads(pe_ops.pe_fusion, logits, pe, y, h, cot)
    for g, w_, name in zip(got, want, ("logits", "y")):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_pe_fusion_function_wiring():
    """`pe_fusion_op` (kernel E's op) on CPU tensors, where it runs the
    plain forward in place of the launch: its gradients through the
    registered backward equal autograd through the plain version."""
    logits, pe, y, h, cot = _fusion_inputs(seed=5)
    got = _torch_fusion_grads(pe_ops.pe_fusion_op, logits, pe, y, h, cot)
    want = _torch_fusion_grads(pe_ops.pe_fusion_plain, logits, pe, y, h, cot)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7)
