"""Depth evaluation metrics and evaluation crops (the port's own copy of
`gedepth_tpu.core.metrics`).

Two implementations of the 9 metrics:
  * numpy, per image, over already-masked 1-D arrays: the evaluation
    protocol's arithmetic, and the source of truth in the tests;
  * torch, batched and masked at fixed shapes (`batched_masked_metrics`,
    the counterpart of `batched_masked_metrics_jax`), which runs on the
    device the predictions are on.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

METRIC_NAMES = (
    "a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log", "silog",
    "sq_rel")


def calculate_metrics(gt: np.ndarray, pred: np.ndarray) -> tuple:
    """The 9 metrics over already-masked 1-D gt/pred arrays, in the order
    of METRIC_NAMES. Empty input gives a tuple of NaNs, which the nanmean
    aggregation skips. A NaN silog is 0."""
    if gt.shape[0] == 0:
        return tuple(np.nan for _ in METRIC_NAMES)

    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())

    err = np.log(pred) - np.log(gt)
    silog = np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100
    if np.isnan(silog):
        silog = 0

    log_10 = np.abs(np.log10(gt) - np.log10(pred)).mean()
    return (a1, a2, a3, abs_rel, rmse, log_10, rmse_log, silog, sq_rel)


def masked_metrics(gt: np.ndarray, pred: np.ndarray, min_depth: float = 1e-3,
                   max_depth: float = 80) -> tuple:
    """Metrics over the open interval (min_depth, max_depth) of the GT."""
    mask = np.logical_and(gt > min_depth, gt < max_depth)
    return calculate_metrics(gt[mask], pred[mask])


def aggregate_metrics(per_image_results) -> "OrderedDict[str, float]":
    """nanmean over a list of per-image metric tuples, by name."""
    columns = tuple(zip(*per_image_results))
    out = OrderedDict()
    for name, col in zip(METRIC_NAMES, columns):
        out[name] = float(np.nanmean(np.asarray(col, dtype=np.float64)))
    return out


def eval_kb_crop(depth: np.ndarray, height: int = 352,
                 width: int = 1216) -> np.ndarray:
    """Bottom-centred KITTI benchmark crop used at eval time."""
    h, w = depth.shape[:2]
    top = int(h - height)
    left = int((w - width) / 2)
    return depth[top:top + height, left:left + width]


def garg_crop_mask(shape) -> np.ndarray:
    """Garg eval crop: rows [0.40810811H, 0.99189189H), columns
    [0.03594771W, 0.96405229W)."""
    h, w = shape
    m = np.zeros((h, w), dtype=bool)
    m[int(0.40810811 * h):int(0.99189189 * h),
      int(0.03594771 * w):int(0.96405229 * w)] = True
    return m


def eigen_crop_mask(shape) -> np.ndarray:
    """Eigen eval crop: rows [0.3324324H, 0.91351351H), columns
    [0.0359477W, 0.96405229W)."""
    h, w = shape
    m = np.zeros((h, w), dtype=bool)
    m[int(0.3324324 * h):int(0.91351351 * h),
      int(0.0359477 * w):int(0.96405229 * w)] = True
    return m


def eval_crop_mask(gt: np.ndarray, min_depth: float, max_depth: float,
                   garg_crop: bool = True,
                   eigen_crop: bool = False) -> np.ndarray:
    """The depth-range mask and, when enabled, the garg crop or else the
    eigen crop."""
    valid = np.logical_and(gt > min_depth, gt < max_depth)
    if garg_crop:
        valid = np.logical_and(valid, garg_crop_mask(gt.shape))
    elif eigen_crop:
        valid = np.logical_and(valid, eigen_crop_mask(gt.shape))
    return valid


def batched_masked_metrics(gt, pred, valid_mask):
    """Per-image metric rows of a batch, on the tensors' device.

    gt, pred: (B, H, W) float tensors; pred > 0 wherever the mask is set
    (the eval steps clamp to [min_depth, max_depth]). valid_mask: (B, H, W)
    bool, the range mask and the eval crop. Returns (B, 9) f32 in the order
    of METRIC_NAMES; an image with an empty mask gives a NaN row, as the
    numpy path does.

    Masked means are sum(x·m)/sum(m); the logarithms see 1 where the mask is
    unset, so no NaN leaks in."""
    m = valid_mask.to(torch.float32)
    n = m.sum(dim=(1, 2))
    safe_n = n.clamp_min(1.0)

    def mmean(x):
        return (x * m).sum(dim=(1, 2)) / safe_n

    gt_s = torch.where(valid_mask, gt.float(), 1.0)
    pred_s = torch.where(valid_mask, pred.float(), 1.0)

    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    a1 = mmean((thresh < 1.25).float())
    a2 = mmean((thresh < 1.25 ** 2).float())
    a3 = mmean((thresh < 1.25 ** 3).float())

    diff = gt_s - pred_s
    abs_rel = mmean(diff.abs() / gt_s)
    sq_rel = mmean(diff ** 2 / gt_s)
    rmse = torch.sqrt(mmean(diff ** 2))

    log_gt, log_pred = torch.log(gt_s), torch.log(pred_s)
    rmse_log = torch.sqrt(mmean((log_gt - log_pred) ** 2))

    err = log_pred - log_gt
    # rounding can leave a variance of a few ulps below zero
    silog = torch.sqrt((mmean(err ** 2) - mmean(err) ** 2).clamp_min(0.0)) \
        * 100

    log_10 = mmean((log_gt - log_pred).abs() / math.log(10.0))

    stacked = torch.stack(
        [a1, a2, a3, abs_rel, rmse, log_10, rmse_log, silog, sq_rel], dim=-1)
    return torch.where((n > 0)[:, None], stacked,
                       torch.full_like(stacked, float("nan")))
