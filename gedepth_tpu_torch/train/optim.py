"""Optimizer and LR schedule (the port of `gedepth_tpu.train.optim`).

AdamW (betas (0.9, 0.999), eps 1e-8, weight decay 0.01) in two parameter
groups: no decay for LayerNorms and relative-position-bias tables, decay
for everything else, BatchNorm included (the reference's mmcv ConvModule
norms are named `bn` and do decay). The no-decay rule reads the parameter's
dotted name as the JAX rule reads flax paths: a component that starts with
`norm`, or `relative_position_bias_table` anywhere.

LR: cosine annealing over max_iters multiplied (not added) by the linear
warmup factor k(t) = 1 − (1 − t/warmup)(1 − warmup_ratio), evaluated at the
number of updates done so far (0 for the first), as optax does.

Gradient clipping in optax's form: g·clip/max(‖g‖, clip) over the global
L2 norm.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def lr_schedule(max_lr: float, max_iters: int, warmup_iters: int,
                warmup_ratio: float = 1e-3, min_lr_ratio: float = 1e-8):
    """schedule(step) -> learning rate (float32 arithmetic, as in JAX)."""
    f32 = np.float32
    min_lr = max_lr * min_lr_ratio

    def schedule(step):
        t = min(f32(step), f32(max_iters))
        lr = f32(min_lr) + f32(max_lr - min_lr) * f32(0.5) * (
            f32(1.0) + f32(np.cos(f32(math.pi) * t / f32(max_iters))))
        if warmup_iters > 0:
            frac = min(max(t / f32(warmup_iters), f32(0.0)), f32(1.0))
            lr = lr * (f32(1.0) - (f32(1.0) - frac) * f32(1.0 - warmup_ratio))
        return float(lr)

    return schedule


def decays(name: str) -> bool:
    """Whether the parameter `name` (a state_dict key) takes weight decay."""
    if "relative_position_bias_table" in name:
        return False
    return not any(part.startswith("norm") for part in name.split("."))


def make_optimizer(model, weight_decay: float = 0.01, betas=(0.9, 0.999)):
    """AdamW over `model`'s parameters in a decay and a no-decay group; the
    train step sets each group's `lr` before every update."""
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if decays(n)],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n)],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale `grads` in place by max_norm/max(‖g‖, max_norm); returns ‖g‖,
    the global norm before the clip (a 0-dim f32 tensor)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
    return norm
