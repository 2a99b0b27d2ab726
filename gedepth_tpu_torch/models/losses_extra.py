"""The toolbox's other losses (the port of
`gedepth_tpu.models.losses_extra`; the reference's depth/models/losses):
no preset trains with them. Masked means at fixed shapes, over this
process's tensors. `bins_chamfer_loss`, the one a preset uses, lives in
`models.losses`, where it reduces over the global batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def l1_loss(pred, target, valid_mask=True, loss_weight=1.0):
    """|pred − target|, the mean over target > 0 (valid_mask) or over
    every element."""
    diff = (pred - target).abs()
    if valid_mask:
        return loss_weight * _masked_mean(diff, target > 0)
    return loss_weight * diff.mean()


def mse_loss(pred, target, valid_mask=True, loss_weight=1.0):
    """(pred − target)², reduced as `l1_loss`."""
    diff = (pred - target) ** 2
    if valid_mask:
        return loss_weight * _masked_mean(diff, target > 0)
    return loss_weight * diff.mean()


def cosine_similarity_loss(pred, target, mask=None, is_abs=False,
                           loss_weight=1.0, axis=-1, eps=1e-8):
    """1 − cos(pred, target) along `axis` per position (1 − |cos| with
    is_abs), the mean over `mask` or over every position."""
    cos = (pred * target).sum(dim=axis) / (
        torch.linalg.vector_norm(pred, dim=axis)
        * torch.linalg.vector_norm(target, dim=axis) + eps)
    val = 1.0 - (cos.abs() if is_abs else cos)
    if mask is not None:
        return loss_weight * _masked_mean(val, mask)
    return loss_weight * val.mean()


def _nll_and_valid(logits, labels, ignore_index):
    labels = labels.long()
    valid = labels != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    logp_t = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])
    return logp_t[..., 0], valid


def focal_loss(logits, labels, gamma=2.0, alpha=0.25, ignore_index=255,
               loss_weight=1.0):
    """Multi-class focal loss −alpha (1 − p_t)^gamma log p_t on logits
    (..., K), the mean over the labels that are not ignored."""
    logp_t, valid = _nll_and_valid(logits, labels, ignore_index)
    val = -alpha * (1 - logp_t.exp()) ** gamma * logp_t
    return loss_weight * _masked_mean(val, valid)


def dice_loss(logits, labels, num_classes=2, ignore_index=255, eps=1.0,
              loss_weight=1.0):
    """Soft Dice of softmax(logits) against the one-hot labels, per row
    (summed over every axis of the labels but the first; over the first
    for 1-D labels) and class, ignored pixels left out; the mean of 1 −
    dice."""
    labels = labels.long()
    ignored = labels == ignore_index
    valid = (~ignored).to(logits.dtype)[..., None]
    probs = torch.softmax(logits, dim=-1) * valid
    onehot = F.one_hot(torch.where(ignored, 0, labels),
                       num_classes).to(logits.dtype) * valid
    dims = tuple(range(1, labels.dim())) if labels.dim() > 1 else (0,)
    inter = (probs * onehot).sum(dim=dims)
    denom = (probs + onehot).sum(dim=dims)
    dice = (2 * inter + eps) / (denom + eps)
    return loss_weight * (1.0 - dice).mean()


def ohem_ce_loss(logits, labels, ignore_index=255, thresh=0.7,
                 min_kept=100000, loss_weight=1.0):
    """Online hard-example mining cross entropy: the pixels whose
    probability of their label is under max(thresh, the min_kept-th
    smallest such probability) are kept; the mean of their NLL."""
    logp_t, valid = _nll_and_valid(logits, labels, ignore_index)
    nll = -logp_t.reshape(-1)
    valid = valid.reshape(-1)
    p_t = torch.where(valid, (-nll).exp(), torch.inf)
    k = min(min_kept, nll.shape[0])
    cut = torch.sort(p_t).values[k - 1].clamp_min(thresh)
    return loss_weight * _masked_mean(nll, valid & (p_t < cut))


def edge_aware_smoothness_loss(inv_depth, image, loss_weight=0.001):
    """Single-scale edge-aware smoothness: the gradients of the
    mean-normalised inverse depth (B, H, W, 1) weighted by exp(−|image
    gradient|) of the image (B, H, W, 3), x and y means summed."""
    d = inv_depth / (inv_depth.mean(dim=(1, 2), keepdim=True) + 1e-7)
    dx = (d[:, :, :-1] - d[:, :, 1:]).abs()
    dy = (d[:, :-1] - d[:, 1:]).abs()
    ix = (image[:, :, :-1] - image[:, :, 1:]).abs().mean(dim=-1,
                                                          keepdim=True)
    iy = (image[:, :-1] - image[:, 1:]).abs().mean(dim=-1, keepdim=True)
    return loss_weight * ((dx * torch.exp(-ix)).mean()
                          + (dy * torch.exp(-iy)).mean())


def accuracy(logits, labels, topk=1, ignore_index=None):
    """Top-k accuracy over the labels that are not ignored; among equal
    logits the later class ranks first, as the JAX argsort's reversal
    ranks it."""
    labels = labels.long()
    valid = (torch.ones_like(labels, dtype=torch.bool)
             if ignore_index is None else labels != ignore_index)
    top = torch.argsort(logits, dim=-1, stable=True).flip(-1)[..., :topk]
    hit = (top == labels[..., None]).any(dim=-1)
    return _masked_mean(hit.float(), valid)
