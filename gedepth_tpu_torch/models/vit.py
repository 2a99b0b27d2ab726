"""Vision Transformer backbone of the zoo's DPT (the port of
`gedepth_tpu.models.vit`), tokens in (B, N, C).

The input is padded at the bottom and right to a multiple of the patch,
then embedded by a patch-sized conv (`patch_embed`). `pos_embed` holds the
class token's position and a 14x14 pretraining grid, resized bilinearly
(half-pixel corners) to the patch grid. Each block is pre-LN (eps 1e-6):
multi-head self-attention, then the FFN with exact GELU. The blocks of
`out_indices` each give (tokens with the class token first, (h, w)).

Attention is flax's `MultiHeadDotProductAttention`: q, k and v projected
(here from one packed (3C, C) `qkv` weight), q scaled by 1/sqrt(head dim)
before the product, softmax(q·kᵀ)·v, an output projection `proj`. The JAX
package computes it with XLA and no Pallas kernel; so does the port, as
plain matrix products. Nothing draws random numbers (no dropout, no
DropPath).

Parameter names: `patch_embed`, `cls_token`, `pos_embed`,
`blocks.{i}.ln1`, `.attn.qkv`, `.attn.proj`, `.ln2` and
`.ffn.layers.{0.0,1}`; `convert.vit_official` maps a timm checkpoint onto
them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import FFN, conv2d, linear
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw

PATCH = 16
PRETRAIN_GRID = 14          # 224 / 16: the grid of `pos_embed`


def out_indices_for(depth: int):
    """The four blocks whose tokens the DPT head takes: round((i+1)·depth/4)
    − 1 (the JAX zoo's rule; 2, 5, 8, 11 at depth 12)."""
    return tuple(round((i + 1) * depth / 4) - 1 for i in range(4))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = linear(dim, 3 * dim)
        self.proj = linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q = qkv[0] * (C // h) ** -0.5
        attn = torch.softmax(q @ qkv[1].transpose(-2, -1), dim=-1)
        out = (attn @ qkv[2]).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn = FFN(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class VisionTransformer(nn.Module):
    def __init__(self, embed_dims: int = 768, depth: int = 12,
                 num_heads: int = 12,
                 out_indices: Sequence[int] = (2, 5, 8, 11)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = conv2d(3, embed_dims, PATCH, stride=PATCH,
                                  init="lecun")
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, PRETRAIN_GRID ** 2 + 1, embed_dims))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dims, num_heads) for _ in range(depth))

    def init_params(self, gen):
        nn.init.zeros_(self.cls_token)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04,
                              generator=gen)

    def forward(self, img):
        """img (B, C, H, W) -> [(tokens (B, 1 + h·w, C), (h, w))] for the
        blocks of `out_indices`, shallow to deep."""
        p = PATCH
        H, W = img.shape[2:]
        img = F.pad(img, (0, (p - W % p) % p, 0, (p - H % p) % p))
        x = self.patch_embed(img)
        B, C, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        g = PRETRAIN_GRID
        grid = self.pos_embed[:, 1:].transpose(1, 2).reshape(1, C, g, g)
        grid = resize_bilinear_nchw(grid, (h, w)).flatten(2).transpose(1, 2)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, C)
        x = torch.cat([cls, x + grid], dim=1)
        outs = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.out_indices:
                outs.append((x, (h, w)))
        return outs
