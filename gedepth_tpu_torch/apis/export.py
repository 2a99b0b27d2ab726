"""Serving export (the port of `gedepth_tpu.apis.export`): the eval step as
a `torch.export` program whose weights live outside it.

    exported, weights, meta = export_depther("gedepth_adaptive_kitti_tpu")
    save_exported("serve/kitti", exported, weights, meta)
    model = load_exported("serve/kitti")          # no model or config code
    depth = model.predict(img)                    # (B, H, W) f32 metres

The program is the eval step of `train.steps.make_eval_step` (forward,
depth clamped to [min_depth, max_depth], resized with align_corners=True,
flip-TTA when the preset has it), traced by `torch.export` at one fixed
(B, H, W, C) and called as fn(weights, img, cam_height) -> (B, H, W) f32
depth. The weights are an input, a flat dict of the model's `state_dict`
tensors, so the program carries none of them and another set of weights of
the same preset serves through the same program.

Artifact layout (a directory):
    model.pt2     the program (`torch.export.save`)
    weights.pt    the weights, a flat dict of tensors
                  (`torch.load(..., weights_only=True)` reads it)
    meta.json     config, input shapes, flip_tta, bf16, device, min and max
                  depth, default_cam_height, the torch version and the
                  port's ops found in the program's graph

The kernels reach the program as the port's dispatcher ops
(`gedepth_torch::window_attention`, `::msda`, `::pe_fusion`), traced
through their fake implementations: the program calls kernels A, B and E on
the card and their plain versions on the CPU. `load_exported` imports
`torch` and those ops' modules, nothing of the model or the configs. The
program is traced on one device and runs there (`meta["device"]`); loading
it on another moves its constants (`torch.export.passes.
move_to_device_pass`).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Union

import numpy as np
import torch

PROGRAM, WEIGHTS, META = "model.pt2", "weights.pt", "meta.json"


class _Step(torch.nn.Module):
    """The eval step as a module over the model, so `functional_call` can
    hand it weights."""

    def __init__(self, model, step):
        super().__init__()
        self.model = model
        self._step = step

    def forward(self, img, cam_height):
        return self._step(img, cam_height)


class _Program(torch.nn.Module):
    """fn(weights, img, cam_height) -> depth. The step module is held
    outside the module tree, so `torch.export` lifts none of its tensors:
    every weight comes in through `weights`."""

    def __init__(self, step: _Step):
        super().__init__()
        self.__dict__["step"] = step

    def forward(self, weights, img, cam_height):
        return torch.func.functional_call(
            self.step, {f"model.{k}": v for k, v in weights.items()},
            (img, cam_height))


def program_ops(exported) -> list:
    """The port's dispatcher ops called by an exported program's graph,
    sorted by name."""
    from gedepth_tpu_torch.ops._lib import NAMESPACE

    return sorted({node.target.name() for node in exported.graph.nodes
                   if getattr(node.target, "namespace", None) == NAMESPACE})


def export_depther(config: Union[str, object],
                   checkpoint: Optional[str] = None, batch: int = 1,
                   hw: Optional[tuple] = None,
                   flip_tta: Optional[bool] = None, bf16: bool = False,
                   device="cuda"):
    """Trace the eval step of `config` on `device`; returns (exported,
    weights, meta). `exported` is a `torch.export.ExportedProgram` called
    as fn(weights, img (B, H, W, C) f32, cam_height (B,) f32) -> (B, H, W)
    f32 depth; `weights` the flat dict of tensors it takes.

    The weights are the port's seeded initialisation or `checkpoint`, a
    params-only `.npz` of either package (as `init_depther` loads it); a
    preset's `bf16_scope` is cast as `init_depther` casts it, and
    `bf16=True` exports the whole-model bf16 step. (H, W) defaults to the
    preset's eval size. TF32 is left as the caller set it."""
    from gedepth_tpu_torch.apis.inference import init_depther
    from gedepth_tpu_torch.configs import image_channels

    handle = init_depther(config, device=device, flip_tta=flip_tta,
                          bf16=bf16, checkpoint=checkpoint)
    cfg, model, device = handle.cfg, handle.model, handle.device
    h, w = hw if hw is not None else cfg.data.eval_size
    img = torch.zeros((batch, h, w, image_channels(cfg)), device=device)
    cam_height = torch.full((batch,), cfg.model.default_cam_height,
                            device=device)
    # one eager step first: the model's index tables, cached by shape and
    # device, are then real tensors that the trace takes as constants
    handle.eval_step(img, cam_height)
    # the step without its inference_mode wrapper, which export does not
    # trace
    program = _Program(_Step(model, handle.eval_step.__wrapped__))
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        exported = torch.export.export(program, (weights, img, cam_height),
                                       strict=False)
    # the example inputs hold the weights: `torch.export.save` would write
    # them into the program
    exported.example_inputs = None
    meta = {
        "config": cfg.name,
        "input": {"img": list(img.shape), "cam_height": [batch]},
        "output": "depth (B, H, W) float32 meters",
        "flip_tta": bool(cfg.data.eval_flip_tta if flip_tta is None
                         else flip_tta),
        "bf16": bool(bf16),
        "device": str(device),
        "min_depth": float(cfg.model.min_depth),
        "max_depth": float(cfg.model.max_depth),
        "default_cam_height": float(cfg.model.default_cam_height),
        "torch_version": torch.__version__,
        "ops": program_ops(exported),
        "export_seconds": time.perf_counter() - t0,
    }
    return exported, weights, meta


def save_exported(out_dir: str, exported, weights, meta) -> None:
    """Write the three-file serving artifact to `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, PROGRAM))
    torch.save(weights, os.path.join(out_dir, WEIGHTS))
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=2)


class ServingModel:
    """A loaded artifact: `predict` without any model or config code.
    `program(weights, img, cam_height)` is the loaded program itself, on
    tensors of `device`."""

    def __init__(self, exported, weights, meta, device):
        self.weights = weights
        self.meta = meta
        self.device = torch.device(device)
        self.program = exported.module()

    def predict(self, img, cam_height=None) -> np.ndarray:
        """img: (B, H, W, C) float32 matching meta['input']; returns
        (B, H, W) float32 depth in metres."""
        img = torch.as_tensor(np.asarray(img, np.float32))
        want = tuple(self.meta["input"]["img"])
        if tuple(img.shape) != want:
            raise ValueError(f"img shape {tuple(img.shape)} != exported "
                             f"{want} (exported programs are shape-static; "
                             "re-export for other shapes)")
        if cam_height is None:
            cam_height = np.full((want[0],), self.meta["default_cam_height"],
                                 np.float32)
        cam_height = torch.as_tensor(np.asarray(cam_height, np.float32))
        with torch.inference_mode():
            out = self.program(self.weights, img.to(self.device),
                               cam_height.to(self.device))
        return out.cpu().numpy()


def load_exported(art_dir: str, device="cuda") -> ServingModel:
    """Load a saved artifact onto `device` (the card by default). Needs
    torch and the port's ops (their modules register them), not the model
    or the configs."""
    # the ops the program calls must be registered before it loads
    from gedepth_tpu_torch.ops import (  # noqa: F401
        msda, pe_fusion, window_attention)

    with open(os.path.join(art_dir, META)) as f:
        meta = json.load(f)
    device = torch.device(device)
    exported = torch.export.load(os.path.join(art_dir, PROGRAM))
    if torch.device(meta["device"]).type != device.type:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, device)
    # a plain dict, the program's input type (a saved `state_dict` loads as
    # an OrderedDict)
    weights = dict(torch.load(os.path.join(art_dir, WEIGHTS),
                              map_location=device, weights_only=True))
    return ServingModel(exported, weights, meta, device)
