"""Ground-mask IoU (the port of `gedepth_tpu.eval.mask_iou`, numpy only):
how well a predicted ground mask matches the "prior agrees with the lidar"
ground truth, per image and over a run, with the reference's >= 60 and
>= 75 IoU buckets (its mask-PE evaluators, off by default there).
"""
from __future__ import annotations

import numpy as np


def mask_iou(pred_mask: np.ndarray, gt_mask: np.ndarray,
             eps: float = 1e-9) -> float:
    """Binary IoU in percent."""
    pred = np.asarray(pred_mask) > 0.5
    gt = np.asarray(gt_mask) > 0.5
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    return float(100.0 * inter / (union + eps))


class MaskIoUAccumulator:
    """Per-image ground-mask IoU and the reference's bucket shares."""

    def __init__(self):
        self.ious = []

    def add(self, pred_mask, gt_mask):
        self.ious.append(mask_iou(pred_mask, gt_mask))

    def summary(self) -> dict:
        ious = np.asarray(self.ious, dtype=np.float64)
        if ious.size == 0:
            return {"miou": float("nan"), "n": 0,
                    "frac_over_60": float("nan"),
                    "frac_over_75": float("nan")}
        return {"miou": float(ious.mean()), "n": int(ious.size),
                "frac_over_60": float((ious >= 60).mean()),
                "frac_over_75": float((ious >= 75).mean())}


def pe_ground_truth_mask(pe: np.ndarray, gt_depth: np.ndarray,
                         rel_tol: float = 0.05) -> np.ndarray:
    """The evaluation's ground truth: the prior within rel_tol (the
    reference's 5%) of the lidar depth, where gt > 0."""
    err = np.divide(np.abs(pe - gt_depth), gt_depth,
                    out=np.zeros_like(gt_depth), where=gt_depth != 0)
    return np.logical_and(err <= rel_tol, gt_depth > 0)
