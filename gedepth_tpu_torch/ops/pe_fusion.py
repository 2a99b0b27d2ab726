"""Adaptive ground-embedding (PE) fusion.

  p = softmax(logits over 11 slope bins); slope = Σ p·centre (degrees)
  t = tan(slope); pe_mask = slope_to_pe_offset(pe, t, h, depth_scale) · y

Shapes (the JAX package's layout): logits (B, H, W, 11); pe, y (B, H, W);
cam_height (B,); returns (B, H, W).

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/pe_fusion.cu`; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from gedepth_tpu_torch.geometry.plane import (
    NUM_SLOPE_BINS, SLOPE_BIN_CENTERS_DEG, slope_to_pe_offset)
from gedepth_tpu_torch.ops import _lib

DEG2RAD = float(np.float32(np.pi / 180.0))


def pe_fusion_plain(slope_logits, pe_comput, y, cam_height, depth_scale):
    """Plain PyTorch version: the math of `pe_fusion_xla`."""
    probs = slope_logits.softmax(dim=-1)
    centers = torch.as_tensor(SLOPE_BIN_CENTERS_DEG, device=probs.device)
    slope_deg = (probs * centers).sum(-1)
    t = torch.tan(slope_deg * DEG2RAD)
    off, _ = slope_to_pe_offset(pe_comput, t, cam_height[:, None, None],
                                depth_scale)
    return off * y


def _check(slope_logits, pe_comput, y, cam_height):
    B, H, W, K = slope_logits.shape
    if K != NUM_SLOPE_BINS:
        raise ValueError(f"pe_fusion takes {NUM_SLOPE_BINS} slope bins, "
                         f"got {K}")
    for name, t in (("pe", pe_comput), ("y", y)):
        if tuple(t.shape) != (B, H, W):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, H, W)}")
    if tuple(cam_height.shape) != (B,):
        raise ValueError(f"cam_height shape {tuple(cam_height.shape)} != "
                         f"{(B,)}")
    for t in (pe_comput, y, cam_height):
        if t.device != slope_logits.device:
            raise ValueError("pe_fusion: all inputs on one device")


def pe_fusion(slope_logits, pe_comput, y, cam_height, depth_scale):
    """Fused slope-bin softmax → prior; the kernel for CUDA tensors."""
    _check(slope_logits, pe_comput, y, cam_height)
    if slope_logits.device.type == "cpu":
        return pe_fusion_plain(slope_logits, pe_comput, y, cam_height,
                               depth_scale)
    if slope_logits.device.type != "cuda":
        raise ValueError(f"pe_fusion: no kernel for {slope_logits.device}")
    for t in (slope_logits, pe_comput, y, cam_height):
        if t.dtype != torch.float32:
            raise TypeError(f"pe_fusion kernel is f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("pe_fusion kernel needs contiguous inputs")
    B, H, W, K = slope_logits.shape
    out = torch.empty_like(pe_comput)
    _lib.call("pe_fusion_fwd", slope_logits.data_ptr(), pe_comput.data_ptr(),
              y.data_ptr(), cam_height.data_ptr(), out.data_ptr(),
              B, H * W, K, float(depth_scale))
    pe_fusion.launches += 1
    return out


pe_fusion.launches = 0
