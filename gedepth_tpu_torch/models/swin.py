"""DepthFormer-Swin backbone: a conv stem over RGB at stride 2 plus a Swin
transformer at stride 4 over the 4-channel RGB+PE input, or over RGB alone
when the model has no ground embedding (the port of
`gedepth_tpu.models.swin`).

Module names follow the reference PyTorch keys (`backbone.conv1`,
`backbone.stages.{i}.blocks.{d}.attn.w_msa.qkv`, `backbone.norm{i}`, ...).
Outputs, NCHW: [stem (H/2, 64), stage1 (H/4, C), stage2 (H/8, 2C),
stage3 (H/16, 4C), stage4 (H/32, 8C)], each stage through its LayerNorm.

Remat (`remat=True`, in training only, as the JAX package's `nn.remat`):
each Swin block keeps only its input for the backward and runs again there
(`torch.utils.checkpoint`), so window attention launches once in the
forward and once in the recompute. The block's DropPath draws from an
explicit generator, which `checkpoint` does not save, so `remat_block`
replays the generator's state for the recompute and puts it back after:
the recompute sees the forward's masks and the generator advances once a
forward, as without remat. The recompute also runs on the parameters the
forward saw, which differ from the module's own in the bf16-compute step.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gedepth_tpu_torch.models.layers import (
    BatchNorm2d, DropPath, FFN, conv2d, linear)
from gedepth_tpu_torch.ops import window_attention as wa


@functools.lru_cache(maxsize=32)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh·ww, wh·ww) index into the (2wh−1)(2ww−1) bias table."""
    ys, xs = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    rel_y = ys[:, None] - ys[None, :] + wh - 1
    rel_x = xs[:, None] - xs[None, :] + ww - 1
    return (rel_y * (2 * ww - 1) + rel_x).astype(np.int64)


@functools.lru_cache(maxsize=64)
def shifted_window_mask(h_pad: int, w_pad: int, window: int,
                        shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask (0 / −100) for shifted windows,
    built on the padded size."""
    img_mask = np.zeros((h_pad, w_pad), dtype=np.int32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh, nw = h_pad // window, w_pad // window
    win = img_mask.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    win = win.reshape(nh * nw, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_array(fn, args, device):
    # a normal tensor even when first built under inference_mode: the
    # cache outlives the call, and autograd refuses inference tensors
    with torch.inference_mode(False):
        return torch.as_tensor(fn(*args), device=device)


def window_partition(x, window: int):
    """(B, H, W, C) -> (B·nH·nW, window², C); H and W divisible."""
    B, H, W, C = x.shape
    x = x.view(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(x, window: int, B: int, H: int, W: int):
    C = x.shape[-1]
    x = x.view(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowMSA(nn.Module):
    """Window multi-head self-attention with relative position bias; the
    packed qkv weight is (3C, C), q is scaled before the attention op."""

    def __init__(self, embed_dims: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = linear(embed_dims, 3 * embed_dims)
        self.proj = linear(embed_dims, embed_dims)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))

    def init_params(self, gen):
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              a=-0.04, b=0.04, generator=gen)

    def forward(self, x, mask=None):
        nWB, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(nWB, N, 3, h, C // h)
        q = qkv[:, :, 0] * (C // h) ** -0.5
        k, v = qkv[:, :, 1], qkv[:, :, 2]   # views: the kernel takes strides
        idx = _device_array(relative_position_index,
                            (self.window, self.window), x.device)
        bias = self.relative_position_bias_table[idx.view(-1)].view(
            N, N, h).permute(2, 0, 1).contiguous()
        out = wa.window_attention(q, k, v, bias, mask)
        return self.proj(out.reshape(nWB, N, C))


class ShiftWindowMSA(nn.Module):
    """Pad to window multiples, cyclic shift, window attention, undo."""

    def __init__(self, embed_dims, num_heads, window, shift: bool):
        super().__init__()
        self.window = window
        self.shift = window // 2 if shift else 0
        self.w_msa = WindowMSA(embed_dims, num_heads, window)

    def forward(self, x, hw_shape):
        B, L, C = x.shape
        H, W = hw_shape
        win, s = self.window, self.shift
        x = x.view(B, H, W, C)
        pad_b, pad_r = (win - H % win) % win, (win - W % win) % win
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = _device_array(shifted_window_mask, (Hp, Wp, win, s),
                                 x.device)
        attn = self.w_msa(window_partition(x, win), mask)
        x = window_reverse(attn, win, B, Hp, Wp)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W, :]
        return x.reshape(B, L, C)


class SwinBlock(nn.Module):
    def __init__(self, embed_dims, num_heads, window, shift: bool,
                 mlp_ratio: int = 4, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window, shift)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, mlp_ratio * embed_dims)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, hw_shape):
        x = x + self.drop_path(self.attn(self.norm1(x), hw_shape))
        return x + self.drop_path(self.ffn(self.norm2(x)))


def remat_block(block: SwinBlock, x, hw_shape):
    """block(x, hw_shape), recomputed in the backward from x. The recompute
    runs on the parameters the forward ran on (under
    `torch.func.functional_call`, as the bf16-compute step calls the model,
    those are the call's bf16 copies, no longer bound to the module when
    the backward runs), and starts the block's generator (DropPath's) from
    the state the forward started from, leaving it where it was."""
    params = dict(block.named_parameters())
    gen = block.drop_path.generator if block.drop_path.rate > 0 else None
    start = None if gen is None else gen.get_state()
    calls = []

    def run(x):
        if not calls:                    # the forward
            calls.append(None)
            return block(x, hw_shape)
        if gen is None:                  # the recompute
            return torch.func.functional_call(block, params, (x, hw_shape))
        resume = gen.get_state()
        gen.set_state(start)
        try:
            return torch.func.functional_call(block, params, (x, hw_shape))
        finally:
            gen.set_state(resume)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class PatchMerging(nn.Module):
    """2x2 space-to-depth (channel-major like nn.Unfold) + LN + Linear."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_channels, eps=1e-5)
        self.reduction = linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x, hw_shape):
        B, L, C = x.shape
        H, W = hw_shape
        x = x.view(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = x.view(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.norm(x)), (H // 2, W // 2)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: conv k = s = patch_size, then LN."""

    def __init__(self, in_channels, embed_dims, patch_size=4):
        super().__init__()
        self.patch_size = patch_size
        self.projection = conv2d(in_channels, embed_dims, patch_size,
                                 stride=patch_size, init="lecun")
        self.norm = nn.LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x):
        ps = self.patch_size
        H, W = x.shape[-2:]
        pad_b, pad_r = (ps - H % ps) % ps, (ps - W % ps) % ps
        if pad_b or pad_r:
            x = F.pad(x, (0, pad_r, 0, pad_b))
        x = self.projection(x)
        hw = (x.shape[2], x.shape[3])
        return self.norm(x.flatten(2).transpose(1, 2)), hw


class SwinStage(nn.Module):
    def __init__(self, embed_dims, depth, num_heads, window, mlp_ratio, dpr,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(embed_dims, num_heads, window, shift=(d % 2 == 1),
                      mlp_ratio=mlp_ratio, drop_path=dpr[d])
            for d in range(depth)])
        self.downsample = (PatchMerging(embed_dims, 2 * embed_dims)
                           if downsample else None)


class DepthFormerSwin(nn.Module):
    """Conv stem (RGB) + Swin stages (RGB+PE when use_pe, else RGB). Input
    NCHW (B, ≥4, H, W), or (B, ≥3, H, W) without PE. `remat`: recompute
    each block in the backward (`remat_block`), in training only."""

    def __init__(self, embed_dims: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 48), window: int = 7,
                 patch_size: int = 4, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.3, stem_channels: int = 64,
                 use_pe: bool = True, remat: bool = True):
        super().__init__()
        self.remat = remat
        self.in_channels = 4 if use_pe else 3
        self.conv1 = conv2d(3, stem_channels, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = BatchNorm2d(stem_channels)
        self.patch_embed = PatchEmbed(self.in_channels, embed_dims,
                                      patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        stages, start, ch = [], 0, embed_dims
        for i, depth in enumerate(depths):
            stages.append(SwinStage(ch, depth, num_heads[i], window,
                                    mlp_ratio, dpr[start:start + depth],
                                    downsample=i < len(depths) - 1))
            start += depth
            self.add_module(f"norm{i}", nn.LayerNorm(ch, eps=1e-5))
            ch *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, img):
        outs = [F.relu(self.bn1(self.conv1(img[:, :3])))]
        x, hw = self.patch_embed(img[:, :self.in_channels])
        use_remat = self.remat and self.training
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = remat_block(block, x, hw) if use_remat else block(x, hw)
            out = getattr(self, f"norm{i}")(x)
            B, _, C = out.shape
            outs.append(out.transpose(1, 2).reshape(B, C, hw[0], hw[1]))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs
