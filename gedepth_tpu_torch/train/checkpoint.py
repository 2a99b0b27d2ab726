"""Checkpoints of the train loop and the JAX package's weights-only `.npz`
(the port of `gedepth_tpu.train.checkpoint`).

A checkpoint holds what the JAX package's orbax checkpoint holds: the
model's `state_dict` (parameters and BatchNorm statistics), the AdamW
`state_dict` (its moments) and `step`, the number of updates done. It is one
`torch.save` file per step, `ckpt_{step:08d}.pt`, written under a temporary
name and renamed, so a file that exists is whole; the newest `max_to_keep`
stay. Saving is synchronous: the loop waits for the write.

`save_params_only` / `load_params_only` read and write the JAX package's
release format: `np.savez` of flat keys `params/<flax path>` and
`batch_stats/<flax path>`, conv kernels HWIO and dense kernels (in, out),
per-block Swin layout (the JAX reader adapts it to either `swin_scan`).
"""
from __future__ import annotations

import os
import os.path as osp
import re
from typing import Optional

import numpy as np
import torch

from gedepth_tpu_torch.convert.from_jax import (
    flax_variables_from_state_dict, load_flax_variables)

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return osp.join(ckpt_dir, f"ckpt_{step:08d}.pt")


def checkpoint_steps(ckpt_dir: str):
    """The steps of the checkpoints in `ckpt_dir`, oldest first."""
    if not osp.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.fullmatch,
                                                os.listdir(ckpt_dir)) if m)


def _write_atomically(path, write):
    """write(file) into `path`.tmp, flushed to disk, then renamed onto
    `path`."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointKeeper:
    """Keeps the newest `max_to_keep` checkpoints of a run in `ckpt_dir`."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 2):
        self.ckpt_dir, self.max_to_keep = ckpt_dir, max_to_keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, state, step: int) -> str:
        """Write `state` (a `train.steps.TrainState`) as the checkpoint of
        `step`, then delete all but the newest `max_to_keep`; returns the
        path written."""
        path = checkpoint_path(self.ckpt_dir, step)
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step)}
        _write_atomically(path, lambda f: torch.save(payload, f))
        for old in checkpoint_steps(self.ckpt_dir)[:-self.max_to_keep]:
            os.remove(checkpoint_path(self.ckpt_dir, old))
        return path


def save_checkpoint(ckpt_dir: str, state, step: int, max_to_keep: int = 2):
    return CheckpointKeeper(ckpt_dir, max_to_keep).save(state, step)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load the checkpoint of `step` (the latest when None) into `state` in
    place and return it. The tensors go to the device of `state`'s model,
    wherever they were saved; the model and the optimizer must have the
    checkpoint's structure."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None and steps:
        step = steps[-1]
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint{'' if step is None else f' of step {step}'} in "
            f"{ckpt_dir} (found steps {steps})")
    device = next(state.model.parameters()).device
    payload = torch.load(checkpoint_path(ckpt_dir, step), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def save_params_only(path: str, model):
    """Write `model`'s weights and BatchNorm statistics to `path` as the JAX
    package's params-only `.npz` (f32), at exactly that path."""
    write_flax_npz(path, *flax_variables_from_state_dict(model.state_dict()))


def write_flax_npz(path: str, params: dict, stats: Optional[dict] = None):
    """Nested (params, batch_stats) trees as the JAX package's `.npz` of
    flat `params/...` and `batch_stats/...` keys, at exactly `path`."""
    flat = {}
    for prefix, tree in (("params", params), ("batch_stats", stats or {})):
        def walk(node, names):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, names + (k,))
                else:
                    flat["/".join((prefix,) + names + (k,))] = v
        walk(tree, ())
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    _write_atomically(path, lambda f: np.savez(f, **flat))


def _unflatten(data, prefix: str) -> dict:
    tree: dict = {}
    for key in data.files:
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return tree


def read_flax_npz(path: str):
    """(params, batch_stats) nested trees of a params-only `.npz`."""
    with np.load(path) as data:
        return _unflatten(data, "params/"), _unflatten(data, "batch_stats/")


def load_params_only(path: str, model):
    """Load a params-only `.npz` of either package (per-block or scanned Swin
    layout) into `model`, strictly; returns the model."""
    return load_flax_variables(model, *read_flax_npz(path))
