"""Training losses (the port of `gedepth_tpu.models.losses`).

sigloss: the scale-invariant log loss sqrt(Var(g) + 0.15·Mean(g)²) of
g = log(pred + eps) − log(gt + eps) over the valid pixels (gt > 0), with
torch.var's unbiased n − 1 variance, computed masked at fixed shapes.

softmax_ce_ignore: the 11-way slope-bin cross entropy, mean over the
pixels whose label is not 255.
"""
from __future__ import annotations

import torch

from gedepth_tpu_torch.geometry.plane import SLOPE_IGNORE_INDEX

SIG_EPS = 1e-3
VARIANCE_FOCUS = 0.15


def sigloss(pred, gt):
    """pred, gt: (B, H, W, 1) or (B, H, W); returns a scalar."""
    pred = pred.reshape(pred.shape[0], -1)
    gt = gt.reshape(gt.shape[0], -1)
    mask = gt > 0
    n = mask.sum().to(pred.dtype)
    g = torch.where(mask, torch.log(pred + SIG_EPS) - torch.log(gt + SIG_EPS),
                    0.0)
    mean = g.sum() / n.clamp_min(1.0)
    var = torch.where(mask, (g - mean) ** 2, 0.0).sum() / (n - 1.0).clamp_min(
        1.0)
    return torch.sqrt(var + VARIANCE_FOCUS * mean ** 2)


def softmax_ce_ignore(logits, labels):
    """logits (B, H, W, K); labels (B, H, W) class ids, float or int."""
    labels = labels.long()
    valid = labels != SLOPE_IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1,
                        torch.where(valid, labels, 0)[..., None])[..., 0]
    m = valid.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
