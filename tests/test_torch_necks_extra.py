"""The port's experiment necks (`models.necks_extra`) against the JAX
package's, on the CPU: each of the 12 necks at small widths on a seeded
pyramid (levels of 32x48 down to 2x3, or HRNet's four), its seeded flax
variables carried to the port's names (`port_state_dict`: the flax module
path with `Conv_0`/`BatchNorm_0` as `conv`/`bn` and a residual block's
`convbn{n}`/`downsample` as `conv{n}`/`bn{n}`/`downsample.{0,1}`), in eval
mode. Tolerance rtol 1e-4, atol 1e-5 of each output's largest value (f32
on both sides, sums in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import necks_extra as jn
from gedepth_tpu_torch.models import necks_extra as tn

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

UP = (8, 12, 16, 24, 32)
HR = (4, 6, 8, 10)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def port_state_dict(variables):
    """The port's state_dict entries of a flax neck's variables."""
    sd = {}
    for collection in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(
            variables.get(collection, {}))[0]
        for path, value in flat:
            names = [getattr(p, "key", str(p)) for p in path]
            out, i = [], 0
            while i < len(names) - 1:
                n = names[i]
                if n.startswith("convbn") and names[i + 1] in ("conv", "bn"):
                    out.append(names[i + 1] + n[len("convbn"):])
                    i += 2
                    continue
                if n == "downsample":
                    out.append(f"downsample.{int(names[i + 1] == 'bn')}")
                    i += 2
                    continue
                out.append({"Conv_0": "conv", "BatchNorm_0": "bn"}.get(n, n))
                i += 1
            arr = np.asarray(value)
            if names[-1] == "kernel":
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                       else arr.T)
            sd[".".join(out + [_LEAF[names[-1]]])] = torch.from_numpy(
                np.ascontiguousarray(arr, np.float32))
    return sd


def pyramid(widths, size=(32, 48), seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, size[0] >> i, size[1] >> i, c))
            .astype(np.float32) for i, c in enumerate(widths)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port_out(x):
    return x.detach().numpy().transpose(0, 2, 3, 1) if x.dim() == 4 \
        else x.detach().numpy()


CASES = {
    "PEMaskNeck": (lambda: jn.PEMaskNeck(UP), lambda: tn.PEMaskNeck(UP),
                   lambda: [pyramid(UP)]),
    "DynamicPEMaskNeck": (lambda: jn.DynamicPEMaskNeck(UP, 11),
                          lambda: tn.DynamicPEMaskNeck(UP, 11),
                          lambda: [pyramid(UP)]),
    "LightDynamicPEMaskNeck": (
        lambda: jn.LightDynamicPEMaskNeck(8, 11),
        lambda: tn.LightDynamicPEMaskNeck(UP, 8, 11),
        lambda: [pyramid(UP)]),
    "DynamicPENeckGlobal": (lambda: jn.DynamicPENeckGlobal(8, 11),
                            lambda: tn.DynamicPENeckGlobal(UP, 8, 11),
                            lambda: [pyramid(UP)]),
    "DynamicPENeckStem": (
        lambda: jn.DynamicPENeckStem(UP, 40),
        lambda: tn.DynamicPENeckStem(UP, 40, stem_channels=6),
        lambda: [pyramid((6,) + UP[1:])]),
    "DynamicAttnPENeck": (lambda: jn.DynamicAttnPENeck(5),
                          lambda: tn.DynamicAttnPENeck(5, stem_channels=6),
                          lambda: pyramid((6,))),
    "DynamicPENeckBackbone": (
        lambda: jn.DynamicPENeckBackbone(HR, (8, 12, 16, 24), 32, 9),
        lambda: tn.DynamicPENeckBackbone(HR, (8, 12, 16, 24), 32, 9),
        lambda: [pyramid(HR, size=(16, 24))]),
    "DynamicPENeckSoft2": (lambda: jn.DynamicPENeckSoft2(8, 11),
                           lambda: tn.DynamicPENeckSoft2(UP, 8, 11),
                           lambda: [pyramid(UP)]),
    "DynamicPENeckSoftHRNet": (
        lambda: jn.DynamicPENeckSoftHRNet(6, 11),
        lambda: tn.DynamicPENeckSoftHRNet(HR, 6, 11),
        lambda: [pyramid(HR, size=(16, 24))]),
    "DynamicPENeckSoftDDR": (lambda: jn.DynamicPENeckSoftDDR(8, 11),
                             lambda: tn.DynamicPENeckSoftDDR(12, 8, 11),
                             lambda: pyramid((12,), size=(12, 20))),
    "DynamicPENeckHeavy": (lambda: jn.DynamicPENeckHeavy(UP, 11),
                           lambda: tn.DynamicPENeckHeavy(UP, 11),
                           lambda: [pyramid(UP)]),
}


def _flatten(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _flatten(x)]
    return [] if out is None else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_neck_matches_jax(name):
    """The neck's outputs (a mask and bin logits, logits an image, or a
    slope) on bridged weights; every port parameter comes from the flax
    tree."""
    make_jax, make_port, make_inputs = CASES[name]
    args = make_inputs()
    jneck = make_jax()
    jargs = [[jnp.asarray(a) for a in x] if isinstance(x, list)
             else jnp.asarray(x) for x in args]
    variables = _random_variables(jneck.init, *jargs, seed=3)
    neck = make_port().eval()
    sd = port_state_dict(variables)
    want_keys = {k for k in neck.state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert set(sd) == want_keys, (set(sd) ^ want_keys)
    neck.load_state_dict(dict(neck.state_dict(), **sd), strict=True)
    want = _flatten(jneck.apply(variables, *jargs))
    targs = [[_nchw(a) for a in x] if isinstance(x, list) else _nchw(x)
             for x in args]
    with torch.no_grad():
        got = _flatten(neck(*targs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = _port_out(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_soft2_detaches_its_inputs():
    """DynamicPENeckSoft2 passes no gradient to its inputs; the other soft
    heads do."""
    xs = [_nchw(a).requires_grad_(True) for a in pyramid(UP)]
    tn.DynamicPENeckSoft2(UP, 8, 11)(xs).sum().backward()
    assert all(x.grad is None for x in xs)
    xs = [_nchw(a).requires_grad_(True) for a in pyramid(HR, (16, 24))]
    tn.DynamicPENeckSoftHRNet(HR, 6, 11)(xs).sum().backward()
    assert all(x.grad is not None for x in xs)


@pytest.mark.parametrize("scales", [None, (1, 0.5, 2, 1.5, 1)])
def test_skip_neck_matches_jax(scales):
    xs = pyramid(UP)
    want = jn.SkipNeck(scales).apply({}, [jnp.asarray(a) for a in xs])
    got = tn.SkipNeck(scales)([_nchw(a) for a in xs])
    assert len(got) == len(want) == len(xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_port_out(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
