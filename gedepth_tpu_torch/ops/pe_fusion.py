"""Adaptive ground-embedding (PE) fusion.

  p = softmax(logits over 11 slope bins); slope = Σ p·centre (degrees)
  t = tan(slope); pe_mask = slope_to_pe_offset(pe, t, h, depth_scale) · y

Shapes (the JAX package's layout): logits (B, H, W, 11); pe, y (B, H, W);
cam_height (B,); returns (B, H, W).

The wrapper calls the dispatcher op `pe_fusion_op`
(`gedepth_torch::pe_fusion`): on a CUDA tensor the hand-written forward
kernel of `csrc/pe_fusion.cu` (E), with the VJP of the plain version as its
backward; on a CPU tensor the plain version.

Kernel E is f32. Inside every `bf16_scope` it sees f32 (the PE necks and the
fusion are always f32); only a model cast to bf16 as a whole hands it bf16
logits, y and PE. The wrapper then lifts them to f32, launches E and rounds
the result to bf16 once; the plain version does the same.
"""
from __future__ import annotations

import numpy as np
import torch

from gedepth_tpu_torch.geometry.plane import (
    NUM_SLOPE_BINS, SLOPE_BIN_CENTERS_DEG, slope_to_pe_offset)
from gedepth_tpu_torch.ops import _lib

DEG2RAD = float(np.float32(np.pi / 180.0))


def pe_fusion_plain(slope_logits, pe_comput, y, cam_height, depth_scale):
    """Plain PyTorch version: the math of `pe_fusion_xla`; bf16 inputs are
    lifted to f32 and the result rounded to bf16 once, as the wrapper does
    around kernel E."""
    if slope_logits.dtype == torch.bfloat16:
        return pe_fusion_plain(slope_logits.float(), pe_comput.float(),
                               y.float(), cam_height.float(),
                               depth_scale).to(slope_logits.dtype)
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


def _check_op_inputs(tensors):
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pe_fusion_op takes f32 inputs (kernel E's one "
                        f"instance), got {[t.dtype for t in tensors]}")


def _launch_forward(slope_logits, pe_comput, y, cam_height, depth_scale):
    """Kernel E on CUDA tensors already checked."""
    B, H, W, K = slope_logits.shape
    out = torch.empty_like(pe_comput)
    _lib.call("pe_fusion_fwd", slope_logits.data_ptr(), pe_comput.data_ptr(),
              y.data_ptr(), cam_height.data_ptr(), out.data_ptr(),
              B, H * W, K, float(depth_scale))
    pe_fusion.launches += 1
    return out


def _pe_fusion_cpu(slope_logits, pe_comput, y, cam_height, depth_scale):
    _check_op_inputs((slope_logits, pe_comput, y, cam_height))
    return pe_fusion_plain(slope_logits, pe_comput, y, cam_height,
                           depth_scale)


def _pe_fusion_cuda(slope_logits, pe_comput, y, cam_height, depth_scale):
    tensors = (slope_logits, pe_comput, y, cam_height)
    _check_op_inputs(tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("pe_fusion kernel needs contiguous inputs")
    return _launch_forward(*tensors, depth_scale)


def _pe_fusion_fake(slope_logits, pe_comput, y, cam_height, depth_scale):
    return pe_comput.new_empty(pe_comput.shape, dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    ctx.depth_scale = inputs[4]
    ctx.save_for_backward(*inputs[:4])


def _backward(ctx, grad_out):
    """The VJP of the plain version, as the JAX package's custom VJP
    differentiates `pe_fusion_xla`."""
    grads = _lib.plain_vjp(pe_fusion_plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], grad_out,
                           ctx.depth_scale)
    return (*grads, None)


# kernel E's op, f32 in and out; on CPU tensors the plain version
pe_fusion_op = _lib.define_op(
    "pe_fusion",
    "(Tensor slope_logits, Tensor pe_comput, Tensor y, Tensor cam_height, "
    "float depth_scale) -> Tensor",
    _pe_fusion_cpu, _pe_fusion_cuda, _pe_fusion_fake, _backward,
    _setup_context)


def pe_fusion(slope_logits, pe_comput, y, cam_height, depth_scale):
    """Fused slope-bin softmax → prior through `pe_fusion_op`: kernel E for
    CUDA tensors, the plain version for CPU tensors. bf16 inputs are lifted
    to f32 and the result rounded to bf16 once."""
    _check(slope_logits, pe_comput, y, cam_height)
    tensors = (slope_logits, pe_comput, y, cam_height)
    dtype = slope_logits.dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in tensors):
        raise TypeError("pe_fusion takes inputs of one dtype, f32 or bf16, "
                        f"got {[t.dtype for t in tensors]}")
    if dtype == torch.bfloat16:
        # E keeps its one f32 instance: lifted in, rounded out once
        tensors = tuple(t.float() for t in tensors)
    return pe_fusion_op(*tensors, float(depth_scale)).to(dtype)


pe_fusion.launches = 0
