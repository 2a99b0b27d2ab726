"""The train step (the port of `gedepth_tpu.train.steps.make_train_step`
and `gedepth_tpu.train.state.TrainState`).

One step: forward in train mode, the half-resolution depth resized to the
GT size with align_corners=True, SigLoss + 0.08·slope CE on the f32 logits,
backward, the global gradient norm of the raw gradients, the clip, then one
AdamW update at the LR the schedule gives for the updates done so far.
PyTorch runs eagerly, so the step is a plain function that updates the
state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gedepth_tpu_torch.models.losses import sigloss, softmax_ce_ignore
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
        """Clip the gradients in the parameters' `.grad`, then one AdamW
        update at schedule(step); returns (the global gradient norm before
        the clip, the LR used)."""
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
    """A loader batch (numpy) as the train step's tensors on `device`."""
    keys = ("img", "depth_gt", "pe_k_gt", "cam_height")
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                     np.float32)).to(device)
            for k in keys if k in batch}


def make_train_step(sig_loss_weight: float = 1.0,
                    slope_ce_weight: float = 0.08):
    """train_step(state, batch) -> metrics, updating `state` in place.

    batch: img (B, H, W, 5), depth_gt (B, H, W) with 0 = invalid, pe_k_gt
    (B, H, W) slope classes, cam_height (B,), tensors on the model's device.
    metrics: loss, loss_depth, loss_slope and grad_norm (0-dim tensors, not
    synchronised) and lr (the rate this update used)."""

    def train_step(state: TrainState, batch):
        model = state.model
        model.train()
        model.set_generator(state.generator)
        state.optimizer.zero_grad(set_to_none=True)

        out = model(batch["img"], batch.get("cam_height"))
        gt = batch["depth_gt"][..., None]
        depth = resize_bilinear(out["depth"].float(), gt.shape[1:3],
                                align_corners=True)
        loss_depth = sig_loss_weight * sigloss(depth, gt)
        loss_slope = slope_ce_weight * softmax_ce_ignore(
            out["slope_logits"].float(), batch["pe_k_gt"])
        loss = loss_depth + loss_slope
        loss.backward()
        grad_norm, lr = state.apply_gradients()
        return {"loss": loss.detach(), "loss_depth": loss_depth.detach(),
                "loss_slope": loss_slope.detach(), "grad_norm": grad_norm,
                "lr": lr}

    return train_step
