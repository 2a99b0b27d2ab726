"""Training losses (the port of `gedepth_tpu.models.losses`).

sigloss: the scale-invariant log loss sqrt(Var(g) + 0.15·Mean(g)²) of
g = log(pred + eps) − log(gt + eps) over the valid pixels (gt > 0, and
gt <= max_depth and valid > 0 where given), with torch.var's unbiased
n − 1 variance, computed masked at fixed shapes.

softmax_ce_ignore: the 11-way slope-bin cross entropy, mean over the
pixels whose label is not 255.

Both are over the global batch: inside a process group (`parallel`) their
counts and sums go through `parallel.global_sum`, so every process gets the
loss of the whole batch, as the JAX package's GSPMD step does.

binary_ce: BCE with logits, mean-reduced (optionally masked), of the
ground-mask pretraining path, over this process's rows.
"""
from __future__ import annotations

import torch

from gedepth_tpu_torch import parallel
from gedepth_tpu_torch.geometry.plane import SLOPE_IGNORE_INDEX

SIG_EPS = 1e-3
VARIANCE_FOCUS = 0.15


def sigloss(pred, gt, valid=None, eps=SIG_EPS, max_depth=None,
            variance_focus=VARIANCE_FOCUS):
    """pred, gt: (B, H, W, 1) or (B, H, W); valid: None or the same layout,
    a pixel counting where valid > 0; max_depth: None, or the largest gt
    that counts. Returns a scalar."""
    pred = pred.reshape(pred.shape[0], -1)
    gt = gt.reshape(gt.shape[0], -1)
    mask = gt > 0
    if max_depth is not None:
        mask = mask & (gt <= max_depth)
    if valid is not None:
        mask = mask & (valid.reshape(valid.shape[0], -1) > 0)
    g = torch.where(mask, torch.log(pred + eps) - torch.log(gt + eps), 0.0)
    # two passes: the mean, then the centred sum of squares
    sum_g, n = parallel.global_sum(
        torch.stack([g.sum(), mask.sum().to(pred.dtype)]))
    mean = sum_g / n.clamp_min(1.0)
    var = parallel.global_sum(
        torch.where(mask, (g - mean) ** 2, 0.0).sum()) / (n - 1.0).clamp_min(
        1.0)
    return torch.sqrt(var + variance_focus * mean ** 2)


def softmax_ce_ignore(logits, labels):
    """logits (B, H, W, K); labels (B, H, W) class ids, float or int."""
    labels = labels.long()
    valid = labels != SLOPE_IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1,
                        torch.where(valid, labels, 0)[..., None])[..., 0]
    m = valid.to(logits.dtype)
    total, n = parallel.global_sum(torch.stack([(nll * m).sum(), m.sum()]))
    return total / n.clamp_min(1.0)


def binary_ce(logits, targets, valid=None):
    """BCE with logits, mean-reduced, or masked by `valid`."""
    loss = (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    if valid is not None:
        m = valid.to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp_min(1.0)
    return loss.mean()
