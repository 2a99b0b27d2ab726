"""Evaluation harness: TTA inference and the reference metric protocol on
one device (the port of `gedepth_tpu.eval.evaluator.Evaluator`;
`build_test_pipeline` lives in `data.transforms`).

KITTI protocol: the input KB-cropped to 352x1216, predictions averaged over
flip-TTA; the GT reloaded at full resolution, KB-cropped, masked by the garg
crop and the range (1e-3, 80); 9 metrics per image, nanmean over the images.
DDAD protocol: the prediction upsampled bilinearly (align_corners=True) to
the full-resolution GT, range mask only. Synthetic frames carry their GT.

The device side runs at fixed shapes (`EvalLoader` pads the last batch); the
per-image metric arithmetic runs in numpy, or on the device with
`device_metrics=True`.
"""
from __future__ import annotations

import numpy as np
import torch

from gedepth_tpu_torch.core.metrics import (
    aggregate_metrics, batched_masked_metrics, calculate_metrics,
    eval_crop_mask, eval_kb_crop)
from gedepth_tpu_torch.data.loader import EvalLoader
from gedepth_tpu_torch.data.transforms import build_test_pipeline
from gedepth_tpu_torch.ops.resize import resize_bilinear
from gedepth_tpu_torch.train.steps import (
    make_eval_step, make_slide_eval_step)


class Evaluator:
    key_metric = "abs_rel"
    rule = "less"

    def __init__(self, model, dataset, data_cfg, batch_size=1, flip_tta=None,
                 ms_ratios=(), device_metrics=False, bf16=False, mode=None,
                 slide_tile=None, slide_stride=None):
        """model: a `GEDepth` on its device, in eval mode.

        bf16=True runs every eval step in bf16 (`make_eval_step`: depth
        clamp and final resize stay f32) on a model that was cast as a whole
        (`apis.inference.cast_params_bf16(model, "all")`); the steps raise
        when the flag and the weights disagree.

        ms_ratios: multi-scale TTA ratios; the predictions of every ratio
        (each at base resolution, each flip-averaged when flip TTA is on)
        are averaged uniformly.

        device_metrics=True computes the 9 per-image metrics on the model's
        device with `batched_masked_metrics` (one call per batch) instead of
        per image in numpy; loading the GT and forming the crop and mask
        stay on the host.

        mode='slide' runs sliding-window inference with window `slide_tile`
        and step `slide_stride` (defaults: the config's train crop size and
        half of it); overlaps are averaged. It does not compose with
        ms_ratios. Default: data_cfg.eval_mode."""
        self.model = model
        self.dataset = dataset
        self.data_cfg = data_cfg
        self.batch_size = batch_size
        self.device_metrics = device_metrics
        self.device = next(model.parameters()).device
        flip = data_cfg.eval_flip_tta if flip_tta is None else flip_tta
        mode = mode or data_cfg.eval_mode
        if mode == "slide":
            if ms_ratios:
                raise ValueError("slide mode does not compose with "
                                 "multi-scale TTA (pick one)")
            tile = slide_tile or data_cfg.crop_size
            stride = slide_stride or (tile[0] // 2, tile[1] // 2)
            self.eval_steps = [make_slide_eval_step(model, tile, stride,
                                                    flip_tta=flip, bf16=bf16)]
        elif mode == "whole":
            self.eval_steps = [make_eval_step(model, flip_tta=flip, ratio=r,
                                              bf16=bf16)
                               for r in (tuple(ms_ratios) or (1.0,))]
        else:
            raise ValueError(f"eval mode {mode!r} is neither 'whole' nor "
                             "'slide'")
        self.pipeline = build_test_pipeline(data_cfg)

    def _gt_for(self, index):
        if hasattr(self.dataset, "load_gt"):
            return self.dataset.load_gt(index)
        return self.dataset[index]["depth_gt"]   # the sample carries its GT

    def _gt_mask_for(self, pred, index):
        """The protocol's host side: (gt, valid mask, prediction) of one
        image, at one shape."""
        gt = self._gt_for(index)
        lo, hi = self.model.min_depth, self.model.max_depth
        if self.data_cfg.dataset == "ddad":
            pred_up = resize_bilinear(
                torch.from_numpy(pred.astype(np.float32))[None, :, :, None],
                gt.shape, align_corners=True)[0, :, :, 0].numpy()
            return gt, (gt > lo) & (gt < hi), pred_up
        if self.data_cfg.dataset == "kitti":
            gt = eval_kb_crop(gt, *self.data_cfg.eval_size)
        mask = eval_crop_mask(gt, lo, hi, garg_crop=self.data_cfg.garg_crop,
                              eigen_crop=self.data_cfg.eigen_crop)
        return gt, mask, pred

    def _device_metrics_batch(self, rows):
        """Metric tuples of (gt, mask, pred) rows of one shape, computed on
        the device in one call."""
        def stack(i):
            return torch.from_numpy(np.stack([r[i] for r in rows])).to(
                self.device)

        vals = batched_masked_metrics(stack(0), stack(2), stack(1))
        return [tuple(row) for row in vals.cpu().numpy()]

    def _predict(self, batch):
        img = torch.from_numpy(np.ascontiguousarray(
            batch["img"], np.float32)).to(self.device)
        ch = None
        if "cam_height" in batch:
            ch = torch.from_numpy(np.ascontiguousarray(
                batch["cam_height"], np.float32)).to(self.device)
        preds = self.eval_steps[0](img, ch)
        if len(self.eval_steps) > 1:
            preds = preds.clone()
            for step in self.eval_steps[1:]:
                preds += step(img, ch)
            preds /= len(self.eval_steps)
        return preds.cpu().numpy()

    def run(self, max_images=None, progress=None, on_prediction=None,
            compute_metrics=True):
        """Evaluate the dataset, or its first `max_images` images; returns
        (aggregate dict by metric name, per-image metric tuples).
        `on_prediction(index, pred)` sees every prediction (H, W) as numpy;
        `progress` prints a line every that many images."""
        loader = EvalLoader(self.dataset, self.pipeline, self.batch_size)
        total = len(loader) * self.batch_size
        per_image, done = [], 0
        for batch, valid in loader:
            preds = self._predict(batch)
            device_rows = []
            for row in range(preds.shape[0]):
                if not valid[row] or (max_images is not None
                                      and done >= max_images):
                    continue
                index = int(batch["index"][row])
                if on_prediction is not None:
                    on_prediction(index, preds[row])
                if compute_metrics:
                    gt, mask, pred = self._gt_mask_for(preds[row], index)
                    if self.device_metrics:
                        device_rows.append((gt, mask, pred))
                    else:
                        per_image.append(calculate_metrics(gt[mask],
                                                           pred[mask]))
                done += 1
                if progress is not None and done % progress == 0:
                    print(f"  eval {done}/{total}", flush=True)
            if device_rows:
                per_image.extend(self._device_metrics_batch(device_rows))
            if max_images is not None and done >= max_images:
                break
        return (aggregate_metrics(per_image) if per_image else {}), per_image
