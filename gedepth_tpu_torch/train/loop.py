"""Iteration-based training on one device (the port of
`gedepth_tpu.train.loop.train`, without DDP): evaluation every
eval_interval steps with save-best, keep-N checkpoints, resume, and a JSONL
log.

A KITTI or DDAD preset reads its splits under cfg.data.data_root (the trees
that `tools.preprocess_data_kitti` and `tools.preprocess_data_ddad` finish)
and augments them by the dataset's chain (`data.transforms`); a synthetic
data config generates its frames at crop_size, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import json
import os.path as osp
import time
from typing import Optional

import torch

from gedepth_tpu_torch.data.ddad import DDADDataset
from gedepth_tpu_torch.data.kitti import KittiDataset
from gedepth_tpu_torch.data.loader import TrainLoader
from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
from gedepth_tpu_torch.data.transforms import build_train_pipeline
from gedepth_tpu_torch.data.wrappers import RepeatDataset
from gedepth_tpu_torch.eval.evaluator import Evaluator
from gedepth_tpu_torch.train.checkpoint import (
    CheckpointKeeper, restore_checkpoint, save_params_only)
from gedepth_tpu_torch.train.steps import (
    batch_to_device, create_train_state, make_train_step)
from gedepth_tpu_torch.utils.env import collect_env


@contextlib.contextmanager
def cudnn_autotuner():
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


def _require(path, what):
    if not osp.exists(path):
        raise FileNotFoundError(f"{what} not found: {path}")


def _dataset(cfg, train: bool):
    """The train or the test split of cfg.data.dataset."""
    d, m = cfg.data, cfg.model
    use_pe = m.pe_variant != "none"
    if d.dataset == "synthetic":
        size = d.synthetic_size if train else max(d.synthetic_size // 4, 2)
        h, w = d.crop_size if train else d.eval_size
        return SyntheticGroundDataset(size=size, height=h, width=w,
                                      depth_scale=m.depth_scale,
                                      max_depth=m.max_depth, use_pe=use_pe,
                                      seed=0 if train else 1)
    if d.dataset not in ("kitti", "ddad"):
        raise NotImplementedError(f"dataset {d.dataset!r} is not ported")
    split = d.train_split if train else d.test_split
    _require(d.data_root, f"{d.dataset} data root")
    _require(split, f"{d.dataset} {'train' if train else 'test'} split")
    kw = dict(use_pe=use_pe, pe_clip=m.depth_scale, min_depth=m.min_depth,
              max_depth=m.max_depth, test_mode=not train,
              load_slope_gt=train and m.pe_variant == "adaptive")
    if d.dataset == "kitti":
        return KittiDataset(d.data_root, split, depth_scale=d.gt_depth_scale,
                            garg_crop=d.garg_crop, eigen_crop=d.eigen_crop,
                            **kw)
    return DDADDataset(d.data_root, split, **kw)


def build_train_dataset(cfg):
    """The train split (`gedepth_tpu.train.loop.build_datasets`): KITTI or
    DDAD from cfg.data.data_root and cfg.data.train_split, or synthetic
    frames at crop_size; wrapped in `RepeatDataset` when
    cfg.data.repeat_times > 1. A missing root or split raises
    FileNotFoundError."""
    train = _dataset(cfg, True)
    if cfg.data.repeat_times > 1:
        train = RepeatDataset(train, cfg.data.repeat_times)
    return train


def build_eval_dataset(cfg):
    """The test split: KITTI or DDAD from cfg.data.test_split in test mode
    (the evaluator reloads the GT at full resolution), or a quarter as many
    synthetic frames as the train split (at least 2) at eval_size, from
    other scenes (seed 1)."""
    return _dataset(cfg, False)


def build_datasets(cfg):
    """(train, test) of cfg.data."""
    return build_train_dataset(cfg), build_eval_dataset(cfg)


LESS_IS_BETTER = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log_10", "silog")
GREATER_IS_BETTER = ("a1", "a2", "a3")


def best_rule(save_best: str, key_metric: str = Evaluator.key_metric):
    """(metric, sign) of the save-best rule: `save_best` when the evaluator
    publishes it, else the evaluator's `key_metric`; sign 1 where less is
    better (the six error metrics), -1 where greater is (a1-a3), so that
    sign·value falls as the model improves."""
    key = (save_best if save_best in LESS_IS_BETTER + GREATER_IS_BETTER
           else key_metric)
    return key, 1.0 if key in LESS_IS_BETTER else -1.0


def evaluate(evaluator, model, max_images=None):
    """One evaluation of `model` in eval mode; its mode is restored after.
    Returns (aggregate metrics, images evaluated, seconds)."""
    was_training = model.training
    model.eval()
    try:
        t0 = time.perf_counter()
        agg, per_image = evaluator.run(max_images=max_images)
        return agg, len(per_image), time.perf_counter() - t0
    finally:
        model.train(was_training)


def train(cfg, work_dir: Optional[str] = None,
          max_iters: Optional[int] = None,
          eval_max_images: Optional[int] = None, resume_state=None,
          resume_from: Optional[str] = None, device="cuda"):
    """Train `cfg` from the port's seeded initialisation, or from a
    checkpoint; returns (state, history, best).

    history: one dict per step, mode 'train': iter, lr, loss, loss_depth,
    loss_slope (adaptive models), grad_norm, time (seconds of the step on a
    synchronised host clock) and, on a CUDA device, peak_mem_mib (the
    step's peak of allocated device memory); and one per evaluation, mode
    'val': iter, the nine metrics, images and time (seconds).
    best: the 'val' record with the best value of the save-best metric
    (`best_rule(cfg.train.save_best)`), or {metric: ±inf} before any.

    Each step takes cfg.train.global_batch samples on this one device; its
    BatchNorm statistics span them all, as the reference's SyncBN spans the
    global batch over its GPUs. cfg.train.bf16_compute runs forward and
    backward in bf16 on f32 master weights (`train.steps.make_train_step`).
    The steps run from the state's step + 1 to max_iters (default
    cfg.train.max_iters, also the length of the LR schedule, as in the JAX
    loop). Every cfg.train.eval_interval steps and at the last, the
    `Evaluator` scores the f32 model on the test split (its first
    `eval_max_images` images when given) in eval mode, whatever the
    precision of training.

    Resuming follows the JAX loop and mmcv's IterBasedRunner: `resume_from`
    (a checkpoint directory; its latest step) or `resume_state` (a
    `TrainState`, such as the first element this returned) gives the
    model, AdamW's moments, the LR schedule's position and the BatchNorm
    statistics; the loader's stream and the dropout generator (seed + 1)
    start again from their beginning, so k steps and a resume for k more
    are not 2k steps.

    work_dir=None writes nothing. With a work_dir: `train.log.jsonl` (an
    'env' record, then a 'train' record every log_interval steps and at the
    last, and every 'val' record), `best_{metric}.npz`
    (`checkpoint.save_params_only`) whenever the metric improves, and the
    newest cfg.train.max_keep_ckpts checkpoints under work_dir/ckpts, one
    every cfg.train.checkpoint_interval steps and at the last.

    TF32 is left as the caller set it (`utils.env.disable_tf32`)."""
    max_iters = max_iters or cfg.train.max_iters
    seed = cfg.train.seed
    if resume_state is not None:
        state = resume_state
        device = next(state.model.parameters()).device
    else:
        device = torch.device(device)
        model = cfg.model.build(device=device,
                                generator=torch.Generator().manual_seed(seed))
        state = create_train_state(model, cfg.optim, max_iters, seed=seed + 1)
    if resume_from:
        restore_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} at iter {state.step}", flush=True)
    state.generator.manual_seed(seed + 1)
    train_step = make_train_step(cfg.optim.sig_loss_weight,
                                 cfg.optim.slope_ce_weight,
                                 bf16=cfg.train.bf16_compute)
    loader = TrainLoader(build_train_dataset(cfg),
                         build_train_pipeline(cfg.data, cfg.model.depth_scale),
                         cfg.train.global_batch, seed=seed)
    evaluator = Evaluator(state.model, build_eval_dataset(cfg), cfg.data)
    key, sign = best_rule(cfg.train.save_best, evaluator.key_metric)
    best = {key: sign * float("inf")}

    history = []
    batches = iter(loader)
    cuda = device.type == "cuda"
    with contextlib.ExitStack() as stack:
        stack.enter_context(cudnn_autotuner())
        stack.enter_context(contextlib.closing(batches))
        log = keeper = None
        if work_dir is not None:
            keeper = CheckpointKeeper(osp.join(work_dir, "ckpts"),
                                      cfg.train.max_keep_ckpts)
            log = stack.enter_context(
                open(osp.join(work_dir, "train.log.jsonl"), "a"))
            log.write(json.dumps({"mode": "env", **{
                k: str(v) for k, v in collect_env().items()}}) + "\n")
            log.flush()

        def write(record):
            if log is not None:
                log.write(json.dumps(record) + "\n")
                log.flush()

        for it in range(state.step, max_iters):
            batch = batch_to_device(next(batches), device)
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            metrics = train_step(state, batch)
            keys = [k for k in ("loss", "loss_depth", "loss_slope",
                                "grad_norm") if k in metrics]
            values = torch.stack([metrics[k] for k in keys]).tolist()
            record = dict(zip(keys, values), iter=it + 1, lr=metrics["lr"],
                          time=time.perf_counter() - t0, mode="train")
            if cuda:
                record["peak_mem_mib"] = (
                    torch.cuda.max_memory_allocated(device) / 2**20)
            history.append(record)
            is_last = it + 1 == max_iters
            if (it + 1) % cfg.train.log_interval == 0 or is_last:
                write(record)
                print(f"iter {it + 1}/{max_iters} loss={record['loss']:.4f} "
                      f"lr={record['lr']:.2e}", flush=True)

            if (it + 1) % cfg.train.eval_interval == 0 or is_last:
                agg, images, seconds = evaluate(evaluator, state.model,
                                                eval_max_images)
                val = {k: float(v) for k, v in agg.items()}
                val.update(iter=it + 1, images=images, time=seconds,
                           mode="val")
                history.append(val)
                write(val)
                print(f"eval @ {it + 1}: " + " ".join(
                    f"{k}={agg[k]:.4f}" for k in dict.fromkeys(
                        (key, "rmse", "a1")) if k in agg), flush=True)
                if sign * val[key] < sign * best[key]:
                    best = val
                    if work_dir is not None:
                        save_params_only(osp.join(work_dir, f"best_{key}.npz"),
                                         state.model)

            if keeper is not None and (
                    (it + 1) % cfg.train.checkpoint_interval == 0 or is_last):
                keeper.save(state, it + 1)
    return state, history, best
