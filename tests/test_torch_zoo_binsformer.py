"""`ZooDepther` 'binsformer' (Swin + BinsFormer head) against the JAX
package, on the CPU: the forward in eval mode (final depth, bin edges,
class logits, `predict_depth`) and in train mode (every decoder layer's
outputs, the BatchNorm statistics); its weight-decay mask is a case of
tests/test_torch_zoo.py::test_zoo_decay_mask_matches_jax. The
weights in and out: tests/test_torch_zoo_binsformer_weights.py.

Seeded numpy variables for the JAX model, carried to the port by
`load_flax_variables`; the same seeded frames through both, the JAX side
under `jax.jit`. Smoke widths: Swin embed 16 (heads 1, 1, 2, 4), head
conv_dim 32, 16 bins, 64x96 RGB frames; the zoo's 6 encoder and 9 decoder
layers. In train mode Swin's DropPath is the identity on both sides (the
two frameworks draw other masks): the rate set to 0 in the port, flax's
module replaced in the JAX package's Swin for the test.

Tolerances as tests/test_torch_zoo.py's: rtol 1e-4 with atol 1e-5 of each
output's largest value for edges, logits and BatchNorm statistics
(train-mode statistics within JAX's own distance from a float64 run on
top), 1e-3 m for depth.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_zoo import _assert_stats_match, _close, _double_copy
from test_torch_zoo_dpt import bridged, image

torch.set_num_threads(1)

H, W = 64, 96
SHRINK = dict(head_channels=32, backbone_embed_dims=16, n_bins=16)


class _Identity:
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@pytest.fixture
def no_droppath(monkeypatch):
    """DropPath as the identity: the JAX Swin's module replaced, and the
    port's rates set to 0 by `quiet`."""
    import gedepth_tpu.models.swin as jswin

    monkeypatch.setattr(jswin, "DropPath", _Identity)


def quiet(model):
    """The port's DropPath at rate 0 (and its generator set, which a
    training forward needs)."""
    from gedepth_tpu_torch.models.layers import DropPath

    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    model.set_generator(torch.Generator().manual_seed(0))
    return model


def binsformer(img, seed=1, **over):
    return bridged("binsformer_nyu", img, seed=seed, **dict(SHRINK, **over))


def _final(got, want, tag):
    assert got["depth"].shape == (2, H // 2, W // 2, 1), tag
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3, err_msg=f"{tag} depth")
    _close(got["bin_edges"].numpy(), want["bin_edges"],
           err_msg=f"{tag} edges")
    _close(got["class_logits"].numpy(), want["class_logits"],
           err_msg=f"{tag} class logits")


def test_zoo_binsformer_matches_jax(no_droppath):
    """Eval: the final layer's depth (at /2), edges (B, 17) and class
    logits (B, 25), and `predict_depth` at the input size; no auxiliary
    outputs. Train: the final outputs, the 8 other decoder layers'
    (`aux_layer_outs`), and the BatchNorm statistics."""
    img = image(seed=2, h=H, w=W, channels=3)
    jmodel, variables, tmodel = binsformer(img)
    x = torch.from_numpy(img)
    want, want_pred = jax.jit(lambda v, a: (
        jmodel.apply(v, a), jmodel.apply(v, a, method=jmodel.predict_depth)))(
            variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(x)
        got_pred = tmodel.predict_depth(x)
    assert "aux_layer_outs" not in got and got["y"] is None
    assert want["aux_layer_outs"] is None
    _final(got, want, "eval")
    assert got_pred.shape == (2, H, W, 1)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-3)

    want, mutated = jax.jit(lambda v, a: jmodel.apply(
        v, a, None, True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(img))
    quiet(tmodel)
    f64 = _double_copy(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
        f64(x.double())
    _final(got, want, "train")
    assert len(got["aux_layer_outs"]) == len(want["aux_layer_outs"]) == 8
    for i, (g, w) in enumerate(zip(got["aux_layer_outs"],
                                   want["aux_layer_outs"])):
        _final(g, w, f"train layer {i}")
    _assert_stats_match(tmodel, mutated["batch_stats"], f64)
