"""The train and eval steps (the port of `gedepth_tpu.train.steps` and
`gedepth_tpu.train.state.TrainState`).

One train step: forward in train mode, the half-resolution depth resized to
the GT size with align_corners=True, SigLoss (+ 0.08·slope CE on the f32
logits when the model is adaptive), backward, the global gradient norm of
the raw gradients, the clip, then one AdamW update at the LR the schedule
gives for the updates done so far. PyTorch runs eagerly, so the step is a
plain function that updates the state in place. `make_zoo_train_step` is
the zoo models' step: the same with SigLoss, and the bin-chamfer,
scene-class and auxiliary-layer terms of AdaBins and BinsFormer;
`make_seg_train_step` the seg model's (`SegOCRNet`): the weighted cross
entropy of each stage of its cascade against the PE ground mask that
`ground_mask_labels` forms from the batch.

More than one process (`parallel`): each process runs the step on its
rows of the global batch. SigLoss, the slope cross entropy and every
BatchNorm reduce their sums over the processes (`parallel.global_sum`, whose
backward all-reduces the gradient), so the loss is the global batch's on
every process and each process's gradient is the world size times its
rows' share; `TrainState.apply_gradients` averages the gradients over the
processes first, which leaves the gradient of the global loss everywhere.
The two factors of the world size cancel only for terms that reach the loss
through `global_sum`, which every term does (the zoo's chamfer and class
cross entropy too). The model is not wrapped in DDP: its keys, attributes
and checkpoints stay those of one process, and the all-reduce runs after the
backward rather than overlapping it.

Eval steps: `make_eval_step` (whole image, flip-TTA, one multi-scale ratio
with the PE channels resampled exactly: `resize_pe_exact`,
`resize_img5_scaled`) and `make_slide_eval_step` (sliding window). They
take (img, cam_height) tensors and return (B, H, W) depth; the model holds
its weights, so there is no params argument.

bf16. The JAX steps cast the parameter tree inside every call. Here the
eval steps' `bf16=True` takes a model whose weights were cast once
(`apis.inference.cast_params_bf16(model, "all")`), casts the input, and
lifts the depth to f32 before the clamp and the final resize; the flag and
the weights must agree. The train step's `bf16=True`
(`TrainConfig.bf16_compute`) casts the f32 master parameters and the input
to bf16 at the apply boundary (`torch.func.functional_call`), so forward and
backward run in bf16 while gradients flow back through the cast into f32
`.grad`s: masters, gradients, the clip, AdamW's moments, the losses and the
BatchNorm statistics stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gedepth_tpu_torch import parallel
from gedepth_tpu_torch.models.losses import (
    bins_chamfer_loss, class_ce, sigloss, softmax_ce_ignore,
    weighted_ce_ignore)
from gedepth_tpu_torch.ops.resize import resize_bilinear
from gedepth_tpu_torch.train.optim import (
    clip_by_global_norm, lr_schedule, make_optimizer)


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step: the model (parameters and
    BatchNorm running statistics), the optimizer with its moments, the LR
    schedule, the generator that DropPath and dropout draw from, and the
    number of updates done."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: Optional[torch.Generator] = None
    grad_clip_norm: float = 35.0
    step: int = 0

    def apply_gradients(self):
        """Average the gradients in the parameters' `.grad` over the
        processes (`parallel.average_gradients`; nothing in a world of
        one), clip them, then one AdamW update at schedule(step); returns
        (the global gradient norm before the clip, the LR used)."""
        parallel.average_gradients(self.model.parameters())
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = clip_by_global_norm(grads, self.grad_clip_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return grad_norm, lr


def create_train_state(model, optim_cfg, max_iters: int, seed: int = 0):
    """A fresh state for `model` (already on its device) under the recipe of
    an `OptimConfig`; the dropout generator lives on the model's device."""
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=make_optimizer(model, optim_cfg.weight_decay,
                                 optim_cfg.betas),
        schedule=lr_schedule(optim_cfg.max_lr, max_iters,
                             optim_cfg.warmup_iters, optim_cfg.warmup_ratio,
                             optim_cfg.min_lr_ratio),
        generator=torch.Generator(device=device).manual_seed(seed),
        grad_clip_norm=optim_cfg.grad_clip_norm)


def batch_to_device(batch, device):
    """A loader batch (numpy arrays or CPU tensors, pinned or not) as the
    train step's f32 tensors on `device`, and `scene_class` (NYU with
    scene classes) as int64."""
    def tensor(x):
        return x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))

    keys = ("img", "depth_gt", "pe_k_gt", "cam_height")
    out = {k: tensor(batch[k]).to(device, torch.float32, non_blocking=True)
           for k in keys if k in batch}
    if "scene_class" in batch:
        out["scene_class"] = tensor(batch["scene_class"]).to(
            device, torch.int64, non_blocking=True)
    return out


def _apply_bf16(model, img, cam_height):
    """The model's forward on bf16 copies of its f32 parameters and of the
    input; the copies are differentiable casts of the masters. Buffers (the
    BatchNorm statistics) are the module's own f32 tensors, updated in
    place."""
    params = {name: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
              for name, p in model.named_parameters()}
    return torch.func.functional_call(
        model, params, (img.to(torch.bfloat16), cam_height))


def _train_forward(state, batch, bf16):
    """The model's forward in train mode on `batch`, its generator set and
    the gradients zeroed: the first half of every train step."""
    model = state.model
    model.train()
    model.set_generator(state.generator)
    state.optimizer.zero_grad(set_to_none=True)
    if bf16:
        return _apply_bf16(model, batch["img"], batch.get("cam_height"))
    return model(batch["img"], batch.get("cam_height"))


def _resized_depth(out, gt):
    """The f32 depth resized to the GT's size with align_corners=True."""
    return resize_bilinear(out["depth"].float(), gt.shape[1:3],
                           align_corners=True)


def _chamfer(out, batch, min_depth):
    """The bin-chamfer distance of `out`'s f32 edges against the GT, at
    weight 1."""
    return bins_chamfer_loss(out["bin_edges"].float(), batch["depth_gt"],
                             min_depth=min_depth, loss_weight=1.0)


def make_train_step(sig_loss_weight: float = 1.0,
                    slope_ce_weight: float = 0.08,
                    sig_max_depth: Optional[float] = None, bf16: bool = False):
    """train_step(state, batch) -> metrics, updating `state` in place.

    sig_max_depth: None, or the largest ground truth SigLoss counts.

    bf16=True runs forward and backward in bf16 on f32 master weights
    (`_apply_bf16`); the losses are taken on f32 copies of the outputs.

    batch: img (B, H, W, 5|3), depth_gt (B, H, W) with 0 = invalid, pe_k_gt
    (B, H, W) slope classes (adaptive models only), cam_height (B,), tensors
    on the model's device. metrics: loss, loss_depth, grad_norm and, for an
    adaptive model, loss_slope (0-dim tensors, not synchronised) and lr (the
    rate this update used)."""

    def train_step(state: TrainState, batch):
        model = state.model
        out = _train_forward(state, batch, bf16)
        gt = batch["depth_gt"][..., None]
        loss = loss_depth = sig_loss_weight * sigloss(
            _resized_depth(out, gt), gt, max_depth=sig_max_depth)
        metrics = {"loss_depth": loss_depth.detach()}
        if model.pe_variant == "adaptive":
            loss_slope = slope_ce_weight * softmax_ce_ignore(
                out["slope_logits"].float(), batch["pe_k_gt"])
            metrics["loss_slope"] = loss_slope.detach()
            loss = loss_depth + loss_slope
        loss.backward()
        grad_norm, lr = state.apply_gradients()
        return dict(metrics, loss=loss.detach(), grad_norm=grad_norm, lr=lr)

    return train_step


def make_zoo_train_step(sig_loss_weight: float = 10.0,
                        aux_loss_indices=(), aux_loss_weights=(),
                        class_ce_weight: float = 0.0,
                        chamfer_weight: float = 0.0, bf16: bool = False):
    """train_step(state, batch) -> metrics for a `ZooDepther` (the port of
    `gedepth_tpu.train.steps.make_zoo_train_step`): the depth resized to
    the GT with align_corners=True, then sig_loss_weight · SigLoss over
    every GT > 0 (no max_depth); and, added to the loss:
      * with chamfer_weight and a model that gives `bin_edges` (AdaBins,
        BinsFormer), chamfer_weight · `bins_chamfer_loss` of the f32 edges
        against the GT (min_depth the model's): metrics["loss_chamfer"];
      * with class_ce_weight, a model that gives `class_logits`
        (BinsFormer) and a batch that carries `scene_class`,
        class_ce_weight · the cross entropy of the f32 logits of the final
        layer (`losses.class_ce`): metrics["loss_ce"];
      * for each (idx, w) of (aux_loss_indices, aux_loss_weights) with idx
        below the count of the model's `aux_layer_outs` (BinsFormer's
        decoder layers but the last), w · the depth term of that layer,
        plus w · chamfer_weight · the chamfer of its edges when the chamfer
        is on: metrics[f"aux_loss_depth_{idx}"].
    Then the gradient norm, the clip, AdamW, the global batch's losses and
    BatchNorm statistics and `bf16` as in `make_train_step`. metrics: loss,
    loss_depth, [loss_chamfer, loss_ce, aux_loss_depth_*,] grad_norm, lr."""

    def train_step(state: TrainState, batch):
        out = _train_forward(state, batch, bf16)
        gt = batch["depth_gt"][..., None]
        min_depth = state.model.min_depth

        def depth_loss(layer):
            return sig_loss_weight * sigloss(_resized_depth(layer, gt), gt)

        loss = loss_depth = depth_loss(out)
        metrics = {}
        if chamfer_weight and out.get("bin_edges") is not None:
            chamfer = chamfer_weight * _chamfer(out, batch, min_depth)
            metrics["loss_chamfer"] = chamfer.detach()
            loss = loss + chamfer
        if (class_ce_weight and out.get("class_logits") is not None
                and "scene_class" in batch):
            ce = class_ce_weight * class_ce(out["class_logits"],
                                            batch["scene_class"])
            metrics["loss_ce"] = ce.detach()
            loss = loss + ce
        aux = out.get("aux_layer_outs") or []
        for idx, w in zip(aux_loss_indices, aux_loss_weights):
            if idx >= len(aux):
                continue
            term = w * depth_loss(aux[idx])
            if chamfer_weight and aux[idx].get("bin_edges") is not None:
                term = term + w * chamfer_weight * _chamfer(aux[idx], batch,
                                                            min_depth)
            metrics[f"aux_loss_depth_{idx}"] = term.detach()
            loss = loss + term
        loss.backward()
        grad_norm, lr = state.apply_gradients()
        metrics.update(loss_depth=loss_depth.detach(), loss=loss.detach(),
                       grad_norm=grad_norm, lr=lr)
        return metrics

    return train_step


MASK_REL_TOL = 0.03


def ground_mask_labels(img, depth_gt, depth_scale: float):
    """The PE ground mask of a batch: class 1 where the prior, channel 3
    times depth_scale (the clipped PE input, pe / depth_scale after the
    loader's normalisation), lies within 3% of the lidar depth and the
    depth is > 0, else 0; int64 (B, H, W)."""
    pe = img[..., 3] * depth_scale
    err = torch.where(depth_gt > 0,
                      (pe - depth_gt).abs() / depth_gt.clamp_min(1e-6),
                      torch.inf)
    return (err <= MASK_REL_TOL).long()


def make_seg_train_step(depth_scale: float = 200.0, aux_weight: float = 0.4):
    """train_step(state, batch) -> metrics for a `SegOCRNet` (the port of
    `gedepth_tpu.train.steps.make_seg_train_step`): the cascade's cross
    entropy against `ground_mask_labels(img, depth_gt, depth_scale)`,
    stage weights aux_weight for every stage but the last and 1.0 for the
    last (0.4 and 1.0: the reference's ocrnet_hr18 loss weights), each a
    `weighted_ce_ignore` of the stage's f32 logits at class weights (0.2,
    1.0), over the global batch. Then the gradient norm, the clip and
    AdamW as in `make_train_step`. The step is f32, as the JAX package's
    seg step is. metrics: loss_seg{i} (weighted), loss, grad_norm, lr."""

    def train_step(state: TrainState, batch):
        out = _train_forward(state, batch, False)
        labels = ground_mask_labels(batch["img"], batch["depth_gt"],
                                    depth_scale)
        logits = out["seg_logits"]
        weights = [aux_weight] * (len(logits) - 1) + [1.0]
        loss, metrics = 0.0, {}
        for i, (w, lg) in enumerate(zip(weights, logits)):
            term = w * weighted_ce_ignore(lg.float(), labels)
            metrics[f"loss_seg{i}"] = term.detach()
            loss = loss + term
        loss.backward()
        grad_norm, lr = state.apply_gradients()
        metrics.update(loss=loss.detach(), grad_norm=grad_norm, lr=lr)
        return metrics

    return train_step


def _predict(model, img, cam_height, size):
    """One forward: depth clamped to [min_depth, max_depth] and resized to
    `size` (align_corners=True), (B, H, W, 1) f32."""
    d = model(img, cam_height)["depth"].float()
    d = d.clamp(model.min_depth, model.max_depth)
    return resize_bilinear(d, size, align_corners=True)


def _with_flip(run, img, flip_tta):
    """run(img), averaged with the un-flipped run of the mirrored image."""
    pred = run(img)
    if flip_tta:
        pred = 0.5 * (pred + run(img.flip(2)).flip(2))
    return pred[..., 0]


def snap32(n: int, ratio: float) -> int:
    """n·ratio snapped to a multiple of 32 (at least 32), so every pyramid
    level of the scaled view stays even."""
    return max(32, int(round(n * ratio / 32)) * 32)


def _cast_input(model, img, bf16):
    """The step's input in the precision its flag names, after holding the
    flag against the model's weights: bf16=True wants a model cast as a
    whole, bf16=False one that is not."""
    whole = all(p.dtype == torch.bfloat16 for p in model.parameters()
                if p.is_floating_point())
    if bf16 != whole:
        raise ValueError(
            "eval step with bf16=True needs a model cast by "
            "cast_params_bf16(model, 'all'), and bf16=False one that was "
            f"not: bf16={bf16}, weights all bf16: {whole}")
    return img.to(torch.bfloat16) if bf16 else img


def make_eval_step(model, flip_tta: bool = True, ratio: float = 1.0,
                   bf16: bool = False):
    """eval_step(img (B, H, W, 5|3), cam_height (B,)) -> (B, H, W) depth.

    Flip-TTA averages the prediction with the un-flipped prediction of the
    mirrored image. ratio != 1.0 is one view of multi-scale TTA: the input
    is resized to the ratio (snapped to multiples of 32) with its PE
    channels resampled exactly (`resize_img5_scaled`), and the prediction
    is resized back to the base resolution.

    bf16=True: the model (cast once as a whole) and the input in bf16, the
    ratio resize on the bf16 input, depth lifted to f32 before the clamp and
    the final resize; f32 out."""
    pe_clip_scale = float(model.depth_scale)

    @torch.inference_mode()
    def eval_step(img, cam_height=None):
        img = _cast_input(model, img, bf16)
        base_hw = tuple(img.shape[1:3])
        if ratio != 1.0:
            img = resize_img5_scaled(
                img, (snap32(base_hw[0], ratio), snap32(base_hw[1], ratio)),
                pe_clip_scale)
        return _with_flip(lambda im: _predict(model, im, cam_height, base_hw),
                          img, flip_tta)

    return eval_step


def resize_pe_exact(pe_raw, size, bound: float = 1e6):
    """Resample the raw plane-embedding channel (B, H, W, 1) exactly under
    a bilinear resize, by interpolating in inverse-depth space: the ground
    plane's depth is c / (a·u + b·v + d), so 1/pe is affine in the pixel
    coordinates, also across the horizon where pe itself diverges.

    Zeros in the input (the horizon row, whose true inverse is 0) map to 0;
    outputs whose inverse magnitude falls below 1/bound are clamped to
    ±bound (an exact 0 stays 0), as `geometry.plane.sanitize_pe_raw` does."""
    f32 = pe_raw.float()
    zero = f32 == 0.0
    inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, f32))
    inv = resize_bilinear(inv, size, align_corners=False)
    small = inv.abs() < (1.0 / bound)
    pe = torch.where(small, torch.sign(inv) * bound,
                     1.0 / torch.where(small, 1.0, inv))
    return pe.to(pe_raw.dtype)


def resize_img5_scaled(img, size, pe_clip_scale: float):
    """The 5-channel model input at `size` with consistent PE channels: RGB
    resized bilinearly, the raw PE (channel 4) resampled exactly, and the
    clipped and normalised PE input (channel 3) recomputed from it with the
    load-time rule: keep (0, clip], divide by `pe_clip_scale` (the model's
    depth_scale). A 3-channel input is resized plainly."""
    if img.shape[-1] != 5:
        return resize_bilinear(img, size, align_corners=False)
    rgb = resize_bilinear(img[..., :3], size, align_corners=False)
    pe_raw = resize_pe_exact(img[..., 4:5], size)
    pr = pe_raw.float()
    pe_in = torch.where((pr > 0) & (pr <= pe_clip_scale), pr / pe_clip_scale,
                        0.0).to(img.dtype)
    return torch.cat([rgb, pe_in, pe_raw], dim=-1)


def slide_positions(size: int, tile: int, stride: int):
    """Window starts covering [0, size): ceil((size − tile) / stride) + 1
    windows, the last pulled back flush with the border."""
    if tile >= size:
        return [0]
    n = -(-(size - tile) // stride) + 1
    return [min(i * stride, size - tile) for i in range(n)]


def make_slide_eval_step(model, tile, stride, flip_tta: bool = True,
                         bf16: bool = False):
    """Sliding-window eval step: eval_step(img, cam_height) -> (B, H, W).

    Every crop of `tile` = (h, w), `stride` apart, runs the same forward;
    depth is clamped per crop, overlapping predictions are averaged through
    an accumulate/count pair (f32), and flip-TTA wraps the whole slide.
    bf16 as in `make_eval_step`."""
    th, tw = int(tile[0]), int(tile[1])
    sh, sw = int(stride[0]), int(stride[1])
    if sh > th or sw > tw:
        raise ValueError(f"stride {stride} must not exceed tile {tile} "
                         "(uncovered gaps)")

    @torch.inference_mode()
    def eval_step(img, cam_height=None):
        img = _cast_input(model, img, bf16)
        B, H, W = img.shape[:3]
        if th > H or tw > W:
            raise ValueError(f"slide tile {(th, tw)} larger than input "
                             f"{(H, W)}; use mode='whole'")
        positions = [(y0, x0) for y0 in slide_positions(H, th, sh)
                     for x0 in slide_positions(W, tw, sw)]

        def run(im):
            acc = im.new_zeros((B, H, W, 1), dtype=torch.float32)
            cnt = im.new_zeros((1, H, W, 1), dtype=torch.float32)
            for (y0, x0) in positions:
                crop = im[:, y0:y0 + th, x0:x0 + tw, :].contiguous()
                acc[:, y0:y0 + th, x0:x0 + tw] += _predict(
                    model, crop, cam_height, (th, tw))
                cnt[:, y0:y0 + th, x0:x0 + tw] += 1.0
            return acc / cnt

        return _with_flip(run, img, flip_tta)

    return eval_step
