"""The port's extra losses (`models.losses_extra`) and the RMI loss
(`models.rmi_loss`) against the JAX package's, on the CPU: the same
seeded numpy inputs, f32 on both sides, with ignored labels and invalid
targets among them. Tolerance rtol 1e-5, atol 1e-7 for the elementwise
losses (reductions in another order); the RMI loss and its MI term
before the clamp at 0 rtol 1e-4, atol 1e-6 (a 9x9 solve and a
log-determinant per class, in f32, whose LAPACK calls differ), and their
gradients in the logits against JAX's, rtol 1e-3 plus 1e-3 of the largest
element.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import losses_extra as jle
from gedepth_tpu.models.rmi_loss import rmi_loss as jax_rmi_loss
from gedepth_tpu_torch.models import losses_extra as tle
from gedepth_tpu_torch.models.rmi_loss import rmi_loss

torch.set_num_threads(1)


def _inputs(seed=0, shape=(2, 12, 16), classes=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, shape + (classes,)).astype(np.float32)
    labels = rng.integers(0, classes, shape).astype(np.int32)
    labels[rng.uniform(size=shape) < 0.2] = 255
    pred = rng.uniform(0.5, 80, shape).astype(np.float32)
    target = rng.uniform(0.5, 80, shape).astype(np.float32)
    target[rng.uniform(size=shape) < 0.3] = 0.0
    return logits, labels, pred, target


def _same(got, want, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss"])
@pytest.mark.parametrize("valid_mask", [True, False])
def test_regression_losses_match_jax(name, valid_mask):
    _, _, pred, target = _inputs()
    want = getattr(jle, name)(jnp.asarray(pred), jnp.asarray(target),
                              valid_mask=valid_mask, loss_weight=0.5)
    got = getattr(tle, name)(_t(pred), _t(target), valid_mask=valid_mask,
                             loss_weight=0.5)
    _same(got, want)


@pytest.mark.parametrize("is_abs", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cosine_similarity_loss_matches_jax(is_abs, masked):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
            for _ in range(2))
    mask = rng.uniform(size=(2, 6, 8)) < 0.6
    kw = dict(is_abs=is_abs, loss_weight=2.0)
    want = jle.cosine_similarity_loss(
        jnp.asarray(a), jnp.asarray(b),
        mask=jnp.asarray(mask) if masked else None, **kw)
    got = tle.cosine_similarity_loss(_t(a), _t(b),
                                     mask=_t(mask) if masked else None, **kw)
    _same(got, want)


@pytest.mark.parametrize("name,kw", [
    ("focal_loss", dict(gamma=2.0, alpha=0.25)),
    ("focal_loss", dict(gamma=0.5, alpha=1.0)),
    ("dice_loss", dict(num_classes=4)),
    ("ohem_ce_loss", dict(thresh=0.7, min_kept=100)),
    ("ohem_ce_loss", dict(thresh=0.05, min_kept=50)),
    ("ohem_ce_loss", dict(thresh=0.7, min_kept=100000))])
def test_classification_losses_match_jax(name, kw):
    logits, labels, _, _ = _inputs(2)
    want = getattr(jle, name)(jnp.asarray(logits), jnp.asarray(labels), **kw)
    got = getattr(tle, name)(_t(logits), _t(labels), **kw)
    _same(got, want)


def test_dice_loss_on_one_axis_labels():
    logits, labels, _, _ = _inputs(3, shape=(40,), classes=3)
    want = jle.dice_loss(jnp.asarray(logits), jnp.asarray(labels),
                         num_classes=3)
    _same(tle.dice_loss(_t(logits), _t(labels), num_classes=3), want)


def test_edge_aware_smoothness_matches_jax():
    rng = np.random.default_rng(4)
    inv = rng.uniform(0.01, 1.0, (2, 10, 14, 1)).astype(np.float32)
    img = rng.normal(size=(2, 10, 14, 3)).astype(np.float32)
    want = jle.edge_aware_smoothness_loss(jnp.asarray(inv), jnp.asarray(img))
    _same(tle.edge_aware_smoothness_loss(_t(inv), _t(img)), want)


@pytest.mark.parametrize("topk,ignore", [(1, None), (2, 255), (3, 255)])
def test_accuracy_matches_jax(topk, ignore):
    logits, labels, _, _ = _inputs(5)
    if ignore is None:
        labels = np.where(labels == 255, 0, labels)
    # ties: the JAX argsort's reversal ranks the later class first
    logits[0, 0, 0] = [1.0, 1.0, 1.0, 0.0]
    want = jle.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk=topk,
                        ignore_index=ignore)
    got = tle.accuracy(_t(logits), _t(labels), topk=topk,
                       ignore_index=ignore)
    _same(got, want)


RMI_CASES = [(11, 3, 3, (2, 30, 36)), (2, 3, 3, (2, 27, 40)),
             (4, 2, 2, (1, 20, 22))]


def _rmi_inputs(classes, shape):
    """Logits, and labels in blocks (the neighbourhoods of the pooled
    one-hot maps vary) with a tenth of the pixels ignored."""
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 1.5, shape + (classes,)).astype(np.float32)
    yy, xx = np.mgrid[:shape[1], :shape[2]]
    labels = np.broadcast_to(((yy // 5 + xx // 7) % classes)[None],
                             shape).astype(np.int32).copy()
    labels[rng.uniform(size=shape) < 0.1] = 255
    return logits, labels


def _value_and_grad(jfn, tfn, logits):
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = tfn(x)
    got.backward()
    _same(got.detach(), want, rtol=1e-4, atol=1e-6)
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-3,
                               atol=1e-3 * float(np.abs(jgrad).max()))
    return float(got.detach())


@pytest.mark.parametrize("classes,radius,pool,shape", RMI_CASES)
def test_rmi_loss_matches_jax(classes, radius, pool, shape):
    """The loss and its gradient in the logits. The MI term, a log-
    determinant of covariances of values in [0, 1], is negative here and
    clamped at 0 on both sides (the next test holds it before the
    clamp)."""
    logits, labels = _rmi_inputs(classes, shape)
    kw = dict(num_classes=classes, rmi_radius=radius, pool_size=pool)
    _value_and_grad(lambda x: jax_rmi_loss(x, jnp.asarray(labels), **kw),
                    lambda x: rmi_loss(x, _t(labels), **kw), logits)


class _NoClamp:
    """`jnp` for the JAX rmi_loss module with its clamp of the MI term at
    0 taken out: maximum(x, 0.0) is x; everything else is jnp's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def maximum(a, b):
        return a if isinstance(b, float) and b == 0.0 else jnp.maximum(a, b)


@pytest.mark.parametrize("classes,radius,pool,shape", RMI_CASES)
def test_rmi_lower_bound_matches_jax(classes, radius, pool, shape,
                                     monkeypatch):
    """The MI term before the clamp (`rmi_lower_bound`) against the JAX
    rmi_loss at bce_weight 0 with its clamp taken out: the 9x9 (4x4)
    solves and log-determinants, and their gradient."""
    import importlib

    monkeypatch.setattr(importlib.import_module(
        "gedepth_tpu.models.rmi_loss"), "jnp", _NoClamp())
    from gedepth_tpu_torch.models.rmi_loss import rmi_lower_bound

    logits, labels = _rmi_inputs(classes, shape)
    kw = dict(num_classes=classes, rmi_radius=radius, pool_size=pool)
    mi = _value_and_grad(
        lambda x: jax_rmi_loss(x, jnp.asarray(labels), bce_weight=0.0, **kw),
        lambda x: rmi_lower_bound(x, _t(labels), **kw), logits)
    assert mi < 0
