"""AdaBins decode head (the port of `gedepth_tpu.models.adabins`; Bhat et
al., CVPR 2021), NCHW, under the reference's module names
(depth/models/decode_heads/adabins_head.py), so a reference `.pth` loads as
is: `conv_list.{i}` (a 1x1 conv, then upsample blocks with ReLU),
`decode_final_conv`, `adaptive_bins_layer` (the mini-ViT: `patch_transformer
.{embedding_convPxP, positional_encodings, transformer_encoder.layers.{i}}`,
`conv3x3`, `regressor.{0,2,4}`) and `conv_out.0`.

The mini-ViT embeds the decoder's map in patches of 16, adds the first
tokens of a (500, E) positional table, and runs four post-LN encoder layers
(4 heads, eps 1e-5, a ReLU FFN of 1024, no dropout: the JAX package's
layer, which torch's `nn.TransformerEncoderLayer` is in eval mode). The
first token regresses the bin widths (LeakyReLU 0.01, relu + 0.1,
normalised); the next `channels` tokens are range queries, dotted with
every pixel of `conv3x3`'s map. `conv_out` and a softmax over the bins give
per-pixel probabilities; the edges are the cumulative widths after
`min_depth`, and depth = Σ p · centre.

Query count. The reference takes exactly `channels` queries, so it needs
more than `channels` patches. The JAX package builds `conv_out` at its first
call with as many inputs as that call had queries, and cannot run another
count after. Here `conv_out` has `channels` inputs, and an input with Q <
`channels` queries uses its first Q (the maps of the missing queries are
zero): the same function as the JAX head built at that size, at every
size. At least 2 patches (one query) and at most 500 (the positional
table) are needed; anything else raises ValueError.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.heads import UpSampleBlock
from gedepth_tpu_torch.models.layers import ConvModule, conv2d, leaky_relu, \
    linear

MAX_TOKENS = 500
PATCH = 16
HEADS, FF_DIM, LAYERS = 4, 1024, 4      # the reference's mViT encoder


class MultiheadAttention(nn.Module):
    """torch `nn.MultiheadAttention`'s parameters (`in_proj_weight` (3E, E),
    `in_proj_bias`, `out_proj`) computed as flax's
    `MultiHeadDotProductAttention`: q scaled by 1/sqrt(head dim) before
    the product."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = linear(dim, dim, init="lecun")

    def init_params(self, gen):
        # flax DenseGeneral's default: lecun normal, per projection
        std = self.in_proj_weight.shape[1] ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.in_proj_weight, std=std, a=-2 * std,
                              b=2 * std, generator=gen)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, x, key=None, value=None):
        """Self-attention over x (B, N, E); with `key` and `value` (B, M,
        E), the attention of the queries x over them (BinsFormer's
        decoder): q, k and v are the three row blocks of in_proj applied to
        x, key and value."""
        B, N, E = x.shape
        h = self.num_heads
        if key is None:
            # one packed product in place of three: AdaBins' self-attention
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
            q, k, v = qkv.view(B, N, 3, h, E // h).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = (F.linear(t, w, b).view(B, -1, h, E // h).transpose(1, 2)
                       for t, w, b in zip((x, key, value),
                                          self.in_proj_weight.chunk(3),
                                          self.in_proj_bias.chunk(3)))
        attn = torch.softmax((q * (E // h) ** -0.5) @ k.transpose(-2, -1),
                             dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, N, E))


class TransformerEncoderLayer(nn.Module):
    """Post-LN: x = LN(x + MHA(x)); x = LN(x + FF(x)), FF = linear2(relu(
    linear1(x)))."""

    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, HEADS)
        self.linear1 = linear(dim, FF_DIM, init="lecun")
        self.linear2 = linear(FF_DIM, dim, init="lecun")
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim)
                                    for _ in range(LAYERS))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PatchTransformerEncoder(nn.Module):
    def __init__(self, embed_dim: int = 128):
        super().__init__()
        self.embedding_convPxP = conv2d(embed_dim, embed_dim, PATCH,
                                        stride=PATCH)
        self.positional_encodings = nn.Parameter(
            torch.zeros(MAX_TOKENS, embed_dim))
        self.transformer_encoder = _Encoder(embed_dim)

    def init_params(self, gen):
        nn.init.uniform_(self.positional_encodings, 0.0, 1.0, generator=gen)

    def forward(self, x):
        """(B, C, H, W) -> tokens (B, S, E), S = (H // p)·(W // p)."""
        # contiguous: the encoder's products then see one layout, eager or
        # in an exported program, and round alike
        tokens = self.embedding_convPxP(x).flatten(2).transpose(
            1, 2).contiguous()
        n = tokens.shape[1]
        if not 2 <= n <= MAX_TOKENS:
            raise ValueError(
                f"AdaBins' mini-ViT needs 2 to {MAX_TOKENS} patches of "
                f"{PATCH} pixels; a "
                f"{tuple(x.shape[2:])} map gives {n}")
        return self.transformer_encoder(tokens + self.positional_encodings[:n])


class MiniViT(nn.Module):
    """(normalised bin widths (B, n_bins), range-attention maps (B, Q, H,
    W)), Q = min(patches − 1, channels)."""

    def __init__(self, channels: int = 128, n_bins: int = 256):
        super().__init__()
        self.channels = channels
        self.patch_transformer = PatchTransformerEncoder(channels)
        self.conv3x3 = conv2d(channels, channels, 3, padding=1)
        self.regressor = nn.Sequential(
            linear(channels, 256, init="lecun"), nn.LeakyReLU(0.01),
            linear(256, 256, init="lecun"), nn.LeakyReLU(0.01),
            linear(256, n_bins, init="lecun"))

    def forward(self, x):
        tokens = self.patch_transformer(x)
        feat = self.conv3x3(x)
        queries = tokens[:, 1:self.channels + 1]
        B, C, H, W = feat.shape
        attn = (queries @ feat.reshape(B, C, H * W)).reshape(B, -1, H, W)
        y = F.relu(self.regressor(tokens[:, 0])) + 0.1
        return y / y.sum(dim=1, keepdim=True), attn


class AdabinsHead(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 up_sample_channels: Sequence[int] = (128, 256, 512, 1024,
                                                      2048),
                 channels: int = 128, n_bins: int = 256,
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        """in_channels and up_sample_channels fine to coarse."""
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        feats, up = list(in_channels)[::-1], list(up_sample_channels)[::-1]
        blocks = [ConvModule(feats[0], up[0], 1, use_bias=True)]
        for i in range(1, len(up)):
            blocks.append(UpSampleBlock(up[i - 1], feats[i], up[i],
                                        act=F.relu))
        self.conv_list = nn.ModuleList(blocks)
        self.decode_final_conv = conv2d(up[-1], channels, 3, padding=1)
        self.adaptive_bins_layer = MiniViT(channels, n_bins)
        self.conv_out = nn.Sequential(conv2d(channels, n_bins, 1))

    def forward(self, inputs):
        """inputs fine to coarse, NCHW. Returns (depth (B, 1, H', W') at the
        finest input's resolution, bin edges (B, n_bins + 1))."""
        feats = inputs[::-1]
        x = self.conv_list[0](feats[0])
        for block, feat in zip(self.conv_list[1:], feats[1:]):
            x = block(x, feat)
        x = self.decode_final_conv(x)
        widths, attn = self.adaptive_bins_layer(x)
        conv = self.conv_out[0]
        q = attn.shape[1]
        logits = F.conv2d(attn, conv.weight[:, :q], conv.bias)
        probs = torch.softmax(logits, dim=1)
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0),
                       value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centres = 0.5 * (edges[:, :-1] + edges[:, 1:])
        depth = (probs * centres[:, :, None, None]).sum(dim=1, keepdim=True)
        return depth, edges
