"""Swin window attention: softmax(q kᵀ + bias[h] + mask[w mod nW]) v.

`window_attention` is the hot op of the Swin backbone: batched attention over
N = window² tokens with a relative-position bias shared across windows and
an optional per-window additive shift mask. q arrives pre-scaled.

Shapes (the JAX package's layout):
  q, k, v  (nWB, N, heads, D)
  bias     (heads, N, N)
  mask     (nW, N, N) or None; windows are laid out (B, nH, nW) row-major,
           so row r uses mask[r % nW]
  returns  (nWB, N, heads, D)

The wrapper calls the dispatcher op `window_attention_op`
(`gedepth_torch::window_attention`): on a CUDA tensor the hand-written
forward kernel (A), with the VJP of the plain version as its backward; on a
CPU tensor the plain version. Kernel A has two instances:
`csrc/window_attention.cu` for f32 q, k, v (f32 bias and mask) and
`csrc/window_attention_bf16.cu`, on the tensor cores, for bf16 q, k, v (bias
and mask each bf16 or f32: a model cast to bf16 holds its bias table in
bf16 and builds its shift mask in f32). The kernels read q, k and
v through their window and row strides, so k and v may be views into a
packed (nWB, N, 3, heads, D) qkv; what they do not take (see
`check_kernel_inputs`) raises.

bf16 inputs give a bf16 output from f32 arithmetic inside, rounded once, in
the kernel and in the plain version alike. (`window_attention_xla` rounds
the logits to bf16 before the softmax; the port does not.)
"""
from __future__ import annotations

import collections

import torch

from gedepth_tpu_torch.ops import _lib

# the kernel pads windows to 64 tokens; head widths are its template
# instances, multiples of 8 up to 64
MAX_TOKENS = 64
HEAD_DIMS = tuple(range(8, 65, 8))


def window_attention_plain(q, k, v, bias, mask=None):
    """Plain PyTorch version: the einsum of `window_attention_xla`. bf16
    inputs are lifted to f32 and the result is rounded to bf16 once, as the
    bf16 kernel computes."""
    if q.dtype == torch.bfloat16:
        return window_attention_plain(q.float(), k.float(), v.float(),
                                      bias.float(), mask).to(q.dtype)
    nWB, N, H, D = q.shape
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(nWB // nW, nW, H, N, N) + \
            mask[None, :, None].to(attn.dtype)
        attn = attn.view(nWB, H, N, N)
    attn = attn.softmax(dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def _check(q, k, v, bias, mask):
    nWB, N, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(H, N, N)}")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N) \
                or nWB % mask.shape[0]:
            raise ValueError(f"mask shape {tuple(mask.shape)} does not tile "
                             f"{nWB} windows of {N} tokens")
    tensors = [q, k, v, bias] + ([] if mask is None else [mask])
    for t in tensors:
        if t.device != q.device:
            raise ValueError("window_attention: all inputs on one device")


def check_kernel_inputs(q, k, v, bias, mask):
    """Raise unless kernel A takes these (shape-checked) inputs as they are:
    q, k, v all f32 or all bf16; N <= 64; D in HEAD_DIMS; q, k, v with unit
    stride over D, head stride D, window and row strides in multiples of 16
    bytes (4 floats, 8 bf16) and 16-byte aligned data (16-byte copies); bias
    and mask contiguous, f32 for the f32 instance, f32 or bf16 for the bf16
    one."""
    nWB, N, H, D = q.shape
    if N > MAX_TOKENS or D not in HEAD_DIMS:
        raise ValueError(f"window_attention kernel takes N <= {MAX_TOKENS} "
                         f"and D in {HEAD_DIMS}, got N={N} D={D}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention kernels are f32 and bf16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"window_attention kernel: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
    allowed = ((torch.float32,) if q.dtype == torch.float32
               else (torch.float32, torch.bfloat16))
    for name, t in (("bias", bias), ("mask", mask)):
        if t is None:
            continue
        if t.dtype not in allowed:
            raise TypeError(f"window_attention {q.dtype} kernel takes a "
                            f"{name} of {allowed}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"window_attention kernel needs a contiguous "
                             f"{name}")
    unit = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        sw, sn, sh, sd = t.stride()
        if sd != 1 or sh != D or sw % unit or sn % unit or t.data_ptr() % 16:
            raise ValueError(
                f"window_attention kernel needs {name} with strides "
                f"({unit}a, {unit}b, {D}, 1) and 16-byte aligned data, got "
                f"strides {t.stride()} at offset {t.data_ptr() % 16} mod 16")


def _launch_forward(q, k, v, bias, mask):
    """Kernel A on CUDA tensors already checked."""
    nWB, N, H, D = q.shape
    out = torch.empty((nWB, N, H, D), dtype=q.dtype, device=q.device)
    nW = 0 if mask is None else mask.shape[0]
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:2], *k.stride()[:2], *v.stride()[:2])
    if q.dtype == torch.bfloat16:
        _lib.call("window_attention_fwd_bf16", *pointers, nWB, N, H, D, nW,
                  int(bias.dtype == torch.bfloat16),
                  int(mask is not None and mask.dtype == torch.bfloat16),
                  *strides)
    else:
        _lib.call("window_attention_fwd", *pointers, nWB, N, H, D, nW,
                  *strides)
    window_attention.launches += 1
    window_attention.launches_by_dtype[q.dtype] += 1
    return out


def _window_attention_cpu(q, k, v, bias, mask):
    return window_attention_plain(q, k, v, bias, mask).contiguous()


def _window_attention_cuda(q, k, v, bias, mask):
    check_kernel_inputs(q, k, v, bias, mask)
    return _launch_forward(q, k, v, bias, mask)


def _window_attention_fake(q, k, v, bias, mask):
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad_out):
    """The VJP of the plain version on the saved inputs, as the JAX
    package's custom VJP differentiates `window_attention_xla` (no TPU
    backward kernel exists). The mask is a constant and gets no
    gradient."""
    q, k, v, bias, mask = ctx.saved_tensors
    grads = _lib.plain_vjp(window_attention_plain, (q, k, v, bias),
                           ctx.needs_input_grad[:4], grad_out, mask)
    return (*grads, None)


# kernel A's op: a contiguous (nWB, N, heads, D) in q's dtype; on CPU
# tensors the plain version
window_attention_op = _lib.define_op(
    "window_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask) -> Tensor",
    _window_attention_cpu, _window_attention_cuda, _window_attention_fake,
    _backward, _setup_context)


def window_attention(q, k, v, bias, mask=None):
    """softmax(q kᵀ + bias + mask) v through `window_attention_op`: kernel A
    for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v, bias, mask)
    return window_attention_op(q, k, v, bias, mask)


window_attention.launches = 0
# the same launches by the dtype of q: which instance ran
window_attention.launches_by_dtype = collections.Counter()
