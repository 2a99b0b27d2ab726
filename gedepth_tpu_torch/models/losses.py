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

bins_chamfer_loss: AdaBins' chamfer distance between the bin centres and
the valid GT depths, both directions, the mean over the global batch's
rows.

class_ce: BinsFormer's scene-class cross entropy, the mean over the global
batch's rows.

weighted_ce_ignore: torch's CrossEntropyLoss(weight, ignore_index) over
the global batch's pixels, the ground-mask classes' loss (class weights
0.2 and 1.0) of the stage-1 pretraining and of the seg train step.
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


CHAMFER_FILL = 1e10


def bins_chamfer_loss(bin_edges, target_depth, min_depth=1e-3,
                      loss_weight=0.1):
    """The bin-centre chamfer distance of the reference's chamferloss.py at
    fixed shapes (`gedepth_tpu.models.losses_extra.bins_chamfer_loss`).

    bin_edges (B, n_bins + 1); target_depth (B, H, W) or (B, H, W, 1). A
    target counts where it is >= min_depth. Centre to target: the squared
    distance to the nearest valid target (invalid ones filled with 1e10),
    the mean over the centres, 0 for a row without a valid target. Target
    to centre: the squared distance of each valid target to its nearest
    centre, the mean over the valid targets. The (B, n_bins, H·W) distance
    tensor is formed whole, as the JAX package forms it. Returns
    loss_weight times the mean over the rows of the two terms' sum."""
    centres = 0.5 * (bin_edges[:, 1:] + bin_edges[:, :-1])     # (B, P)
    t = target_depth.reshape(target_depth.shape[0], -1)         # (B, T)
    valid = t >= min_depth
    d2 = (centres[:, :, None] - t[:, None, :]) ** 2             # (B, P, T)
    x2y = torch.where(valid[:, None, :], d2, CHAMFER_FILL).amin(dim=2)
    x2y = torch.where(valid.any(dim=1)[:, None], x2y, 0.0).mean(dim=1)
    y2x = torch.where(valid, d2.amin(dim=1), 0.0).sum(dim=1) / \
        valid.sum(dim=1).clamp_min(1).to(d2.dtype)
    rows = x2y + y2x
    total, n = parallel.global_sum(torch.stack(
        [rows.sum(), rows.new_tensor(float(rows.shape[0]))]))
    return loss_weight * total / n


def class_ce(logits, labels):
    """logits (B, K), labels (B,) class ids: the mean over the global
    batch's rows of −log_softmax(logits)[label], in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    total, n = parallel.global_sum(torch.stack(
        [nll.sum(), nll.new_tensor(float(nll.shape[0]))]))
    return total / n


CLASS_WEIGHTS = (0.2, 1.0)


def weighted_ce_ignore(logits, labels, class_weights=CLASS_WEIGHTS,
                       ignore_index: int = 255):
    """torch's CrossEntropyLoss(weight=w, ignore_index) on NHWC logits:
    sum(w_y · nll) / sum(w_y) over the pixels whose label is not ignored."""
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=logits.dtype,
                        device=logits.device)[safe] * valid.to(logits.dtype)
    total, weight = parallel.global_sum(torch.stack([(nll * w).sum(),
                                                     w.sum()]))
    return total / weight.clamp_min(1e-8)
