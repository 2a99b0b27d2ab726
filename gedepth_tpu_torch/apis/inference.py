"""Single-image inference (the port of `gedepth_tpu.apis.inference`).

  handle = init_depther("gedepth_adaptive_kitti_tpu", device="cuda",
                        pe_path="input/2011_09_26/pe/pe_165.npy")
  depth = inference_depther(handle, "frame.png")   # (352, 1216) metres

A raw image (an RGB array, or a PNG path read by `utils.png`) goes through
the preset's test pipeline (KITTI: KB crop, normalisation; DDAD: resize to
384x640, normalisation), then the eval step: forward, clamp to [min_depth, max_depth], resize to the
input size with align_corners=True, and with flip-TTA the mean of the
prediction and the un-flipped prediction of the mirrored image
(`train.steps.make_eval_step`). A model without ground embedding
(pe_variant 'none'), or a preset of an RGB-only dataset (NYU), takes the
RGB image alone.

Precision: a preset with a `bf16_scope` (`gedepth_adaptive_kitti_parity`:
Swin and the decode head in bf16, HAHI, the PE necks and the fusion in f32)
gets the scope's parameters cast once at start; `bf16=True` casts the whole
model once and serves through the bf16 eval step (depth clamp and final
resize in f32). `cast_params_bf16` is the cast, for a caller's own model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from gedepth_tpu_torch.configs import get_config, image_channels
from gedepth_tpu_torch.data.transforms import build_test_pipeline
from gedepth_tpu_torch.geometry.plane import clip_pe_for_input
from gedepth_tpu_torch.train.checkpoint import load_params_only
from gedepth_tpu_torch.utils.png import read_rgb
from gedepth_tpu_torch.train.steps import make_eval_step  # noqa: F401


# the top-level modules whose parameters and BatchNorm statistics each scope
# holds in bf16 (the caller's half of `GEDepth.bf16_scope`)
SCOPE_MODULES = {"backbone": ("backbone",),
                 "backbone_neck": ("backbone", "neck"),
                 "backbone_head": ("backbone", "decode_head"),
                 "backbone_neck_head": ("backbone", "neck", "decode_head")}


def cast_params_bf16(model, scope: str = "all"):
    """Cast f32 parameters and buffers of `model` to bf16 in place, within a
    scope; returns the model.

    scope='all' casts the whole model (full-bf16 serving and evaluation);
    a `GEDepth.bf16_scope` name casts only that scope's top-level modules
    (`SCOPE_MODULES`): the model casts activations at the scope's boundary,
    this casts the matching weights, or type promotion lifts the compute
    back to f32. Only f32 tensors are cast: BatchNorm's running statistics
    are, integer buffers (`num_batches_tracked`) are not. The `state_dict`
    keeps its keys."""
    if scope == "all":
        modules = [model]
    elif scope in SCOPE_MODULES:
        modules = [getattr(model, name) for name in SCOPE_MODULES[scope]]
    else:
        raise ValueError(f"bf16 scope {scope!r} not in "
                         f"{('all', *SCOPE_MODULES)}")
    with torch.no_grad():
        for module in modules:
            for t in (*module.parameters(), *module.buffers()):
                if t.dtype == torch.float32:
                    t.data = t.data.to(torch.bfloat16)
    return model


@dataclasses.dataclass
class DeptherHandle:
    cfg: object
    model: object
    eval_step: object
    pipeline: object
    device: torch.device
    pe_raw: Optional[np.ndarray] = None


def load_pe(path: str) -> np.ndarray:
    """A camera's raw plane embedding from an `.npy` array or the `pe` of an
    `.npz` (`tools.preprocess_data_kitti`, `tools.preprocess_data_ddad`),
    float32."""
    with open(path, "rb") as f:
        arr = np.load(f)
        return (arr["pe"] if hasattr(arr, "files") else arr).astype(
            np.float32)


def init_depther(config: Union[str, object], device="cuda",
                 flip_tta: Optional[bool] = None,
                 pe_raw: Optional[np.ndarray] = None, seed: int = 0,
                 state_dict: Optional[dict] = None,
                 bf16: bool = False,
                 checkpoint: Optional[str] = None,
                 pe_path: Optional[str] = None) -> DeptherHandle:
    """Build a model and its eval step for single-image inference.

    The weights are the port's seeded random initialisation, or
    `state_dict` (e.g. `convert.state_dict_from_flax`) loaded strictly, or
    `checkpoint`, a params-only `.npz` of either package
    (`train.checkpoint.load_params_only`: the train loop's best weights,
    `tools.convert_torch_checkpoint`'s output), loaded strictly before any
    bf16 cast. TF32 is left as the caller set it.
    pe_raw: the camera's raw plane embedding at the raw image size, needed
    when feeding 3-channel images to a model with a PE variant; or
    pe_path, a file holding it (`load_pe`).
    bf16: serve the whole model in bf16 (cast once here; the eval step casts
    the input and returns f32 depth). Without it, a preset whose
    `bf16_scope` is not 'none' gets that scope's weights cast once.
    """
    cfg = get_config(config) if isinstance(config, str) else config
    device = torch.device(device)
    model = cfg.model.build(generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if checkpoint is not None:
        load_params_only(checkpoint, model)
    model.to(device)
    if bf16:
        cast_params_bf16(model, "all")
    elif cfg.model.bf16_scope != "none":
        cast_params_bf16(model, cfg.model.bf16_scope)
    flip = cfg.data.eval_flip_tta if flip_tta is None else flip_tta
    if pe_path is not None:
        if pe_raw is not None:
            raise ValueError("pass pe_raw or pe_path, not both")
        pe_raw = load_pe(pe_path)
    if pe_raw is not None:
        pe_raw = np.asarray(pe_raw, dtype=np.float32)
    return DeptherHandle(cfg, model,
                         make_eval_step(model, flip_tta=flip, bf16=bf16),
                         build_test_pipeline(cfg.data), device, pe_raw)


def inference_depther(handle: DeptherHandle,
                      image: Union[str, np.ndarray],
                      cam_height: Optional[float] = None) -> np.ndarray:
    """Depth of one image: a PNG path, (H, W, 3) RGB in 0..255 or an
    (H, W, 5) sample image; returns an (H', W') depth map at the eval
    resolution."""
    if isinstance(image, str):
        image = read_rgb(image)
    image = np.asarray(image, dtype=np.float32)
    cfg = handle.cfg
    sample = {"img": image,
              "cam_height": np.float32(cam_height if cam_height is not None
                                       else cfg.model.default_cam_height)}
    if image_channels(cfg) == 5 and image.shape[-1] != 5:
        if handle.pe_raw is None:
            raise ValueError("PE variant needs a plane embedding: pass "
                             "pe_path or pe_raw to init_depther or a "
                             "5-channel image")
        if handle.pe_raw.shape != image.shape[:2]:
            raise ValueError(f"pe shape {handle.pe_raw.shape} != image "
                             f"{image.shape[:2]}")
        pe_in = clip_pe_for_input(handle.pe_raw, cfg.model.depth_scale)
        sample["img"] = np.concatenate(
            [image, pe_in[..., None], handle.pe_raw[..., None]], axis=-1)
    sample = handle.pipeline(sample)
    img = torch.from_numpy(np.ascontiguousarray(sample["img"][None])).to(
        handle.device)
    ch = torch.tensor([sample["cam_height"]], device=handle.device)
    return handle.eval_step(img, ch)[0].cpu().numpy()
