"""Region mutual information loss (the port of
`gedepth_tpu.models.rmi_loss`; the reference's rmiloss.py, Zhao et al.
2019): a lower bound of the mutual information between the label's and the
prediction's neighbourhoods, I(A; B) >= H(A) - H(A|B), next to the
one-vs-rest BCE.

loss = bce_weight · BCE(sigmoid(logits), one-hot labels) + (1 −
bce_weight) · max(MI term, 0), where the MI term is 0.5 · logdet of the
conditional covariance of the label vectors given the prediction vectors
over rmi_radius x rmi_radius neighbourhoods of the pool_size-average-pooled
maps, divided by rmi_radius², summed over the classes and averaged over
the batch. `torch.linalg.solve` and `slogdet` run in the logits' dtype.
No preset uses it: a library function, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

COV_EPS = 5e-4


def _neighborhood_vectors(x, radius):
    """(B, H, W, C) -> (B, C, radius², M): the radius x radius shifted
    crops of every position, stacked."""
    B, H, W, C = x.shape
    nh, nw = H - (radius - 1), W - (radius - 1)
    v = torch.stack([x[:, dy:dy + nh, dx:dx + nw, :]
                     for dy in range(radius) for dx in range(radius)],
                    dim=-1)                            # (B, nh, nw, C, d2)
    return v.reshape(B, nh * nw, C, radius * radius).permute(0, 2, 3, 1)


def _pool(x, size):
    """Average pooling of NHWC by size x size, the remainder rows and
    columns dropped."""
    B, H, W, C = x.shape
    ph, pw = H // size, W // size
    x = x[:, :ph * size, :pw * size]
    return x.reshape(B, ph, size, pw, size, C).mean(dim=(2, 4))


def _targets(logits, labels, num_classes, ignore_index):
    """(valid mask (B, H, W, 1) in the logits' dtype, one-hot labels,
    sigmoid probabilities), both zero where the label is ignored."""
    labels = labels.long()
    valid = labels != ignore_index
    vmask = valid[..., None].to(logits.dtype)
    onehot = F.one_hot(torch.where(valid, labels, 0),
                       num_classes).to(logits.dtype) * vmask
    return vmask, onehot, torch.sigmoid(logits) * vmask


def rmi_lower_bound(logits, labels, num_classes=11, ignore_index=255,
                    rmi_radius=3, pool_size=3):
    """The MI term before `rmi_loss` clamps it at 0: over the classes'
    pooled neighbourhood vectors, 0.5 · logdet(var_y − cov_yp var_p⁻¹
    cov_ypᵀ + eps·I) / rmi_radius², summed over the classes, the mean over
    the batch (var_p and the conditional covariance regularised by eps =
    5e-4)."""
    _, onehot, probs = _targets(logits, labels, num_classes, ignore_index)
    y = _neighborhood_vectors(_pool(onehot, pool_size), rmi_radius)
    p = _neighborhood_vectors(_pool(probs, pool_size), rmi_radius)
    y = y - y.mean(dim=-1, keepdim=True)
    p = p - p.mean(dim=-1, keepdim=True)
    d2, m = rmi_radius * rmi_radius, y.shape[-1]
    eye = torch.eye(d2, dtype=logits.dtype, device=logits.device)
    var_y = y @ y.transpose(-1, -2) / m
    var_p = p @ p.transpose(-1, -2) / m + COV_EPS * eye
    cov_yp = y @ p.transpose(-1, -2) / m
    sol = torch.linalg.solve(var_p, cov_yp.transpose(-1, -2))
    cond = var_y - cov_yp @ sol + COV_EPS * eye
    _, logdet = torch.linalg.slogdet(cond)
    return (0.5 * logdet / float(d2)).sum(dim=1).mean()


def rmi_loss(logits, labels, num_classes=11, ignore_index=255,
             rmi_radius=3, pool_size=3, bce_weight=0.5):
    """logits (B, H, W, K) NHWC; labels (B, H, W) class ids, int or
    float; pixels labelled ignore_index count in neither term. Returns a
    scalar: the masked one-vs-rest BCE (the mean over the valid pixels and
    the classes) and `rmi_lower_bound` clamped at 0."""
    vmask, onehot, _ = _targets(logits, labels, num_classes, ignore_index)
    bce = (logits.clamp_min(0) - logits * onehot
           + torch.log1p(torch.exp(-logits.abs())))
    bce = (bce * vmask).sum() / (vmask.sum() * num_classes).clamp_min(1.0)
    mi = rmi_lower_bound(logits, labels, num_classes, ignore_index,
                         rmi_radius, pool_size)
    return bce_weight * bce + (1.0 - bce_weight) * mi.clamp_min(0.0)
