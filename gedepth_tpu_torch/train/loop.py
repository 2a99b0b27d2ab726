"""Iteration-based training on one device (the port of
`gedepth_tpu.train.loop.train`, without eval, checkpoints, resume or DDP).

The repository holds no KITTI data, so a KITTI preset trains on
`SyntheticGroundDataset` frames at its KB-cropped size (eval_size,
352x1216), which the synthetic augmentation branch (flip, random crop to
crop_size, colour, normalise) cuts to the training crop; a synthetic preset
generates its frames at crop_size, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from typing import Optional

import torch

from gedepth_tpu_torch.data.loader import TrainLoader
from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
from gedepth_tpu_torch.data.transforms import build_train_pipeline
from gedepth_tpu_torch.train.steps import (
    batch_to_device, create_train_state, make_train_step)


@contextlib.contextmanager
def _cudnn_autotuner():
    """cuDNN's autotuner on (`torch.backends.cudnn.benchmark`), restored
    after. Its default heuristic picks FFT algorithms for the f32 3x3
    convolutions at 88x176 of the 352x704 crop: 66 GB of workspace and
    ~0.45 s of every train step on an H100 (PERF.md)."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def build_train_dataset(cfg):
    d, m = cfg.data, cfg.model
    if d.dataset == "synthetic":
        h, w = d.crop_size
    elif d.dataset == "kitti":
        h, w = d.eval_size       # synthetic stand-in for the KB-cropped frame
    else:
        raise NotImplementedError(f"dataset {d.dataset!r} is not ported yet")
    return SyntheticGroundDataset(size=d.synthetic_size, height=h, width=w,
                                  depth_scale=m.depth_scale,
                                  max_depth=m.max_depth)


def train(cfg, work_dir: Optional[str] = None,
          max_iters: Optional[int] = None, device="cuda"):
    """Train `cfg` from the port's seeded initialisation; returns
    (state, history) with one dict of floats per step: iter, lr, loss,
    loss_depth, loss_slope, grad_norm, time (seconds of the step on a
    synchronised host clock) and, on a CUDA device, peak_mem_mib (the
    step's peak of allocated device memory).

    Each step takes cfg.train.global_batch samples on this one device; its
    BatchNorm statistics span them all, as the reference's SyncBN spans the
    global batch over its GPUs. max_iters: steps to run, and the length of
    the LR schedule, as in the JAX loop (default cfg.train.max_iters).
    work_dir: where `train.log.jsonl` is appended, one line every
    log_interval steps and at the last (none when None)."""
    device = torch.device(device)
    max_iters = max_iters or cfg.train.max_iters
    seed = cfg.train.seed
    model = cfg.model.build(device=device,
                            generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, cfg.optim, max_iters, seed=seed + 1)
    train_step = make_train_step(cfg.optim.sig_loss_weight,
                                 cfg.optim.slope_ce_weight)
    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data, cfg.model.depth_scale),
                         cfg.train.global_batch, seed=seed)
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)

    history = []
    batches = iter(loader)
    cuda = device.type == "cuda"
    with _cudnn_autotuner(), contextlib.closing(batches):
        for it in range(max_iters):
            batch = batch_to_device(next(batches), device)
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            metrics = train_step(state, batch)
            values = torch.stack([metrics[k] for k in (
                "loss", "loss_depth", "loss_slope", "grad_norm")]).tolist()
            record = dict(zip(("loss", "loss_depth", "loss_slope",
                               "grad_norm"), values),
                          iter=it + 1, lr=metrics["lr"],
                          time=time.perf_counter() - t0)
            if cuda:
                record["peak_mem_mib"] = (
                    torch.cuda.max_memory_allocated(device) / 2**20)
            history.append(record)
            if work_dir is not None and (
                    (it + 1) % cfg.train.log_interval == 0
                    or it + 1 == max_iters):
                with open(osp.join(work_dir, "train.log.jsonl"), "a") as f:
                    f.write(json.dumps(dict(record, mode="train")) + "\n")
    return state, history
