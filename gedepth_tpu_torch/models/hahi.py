"""HAHI neck: deformable self-attention over the four Swin levels (HI) and
deformable cross-attention from the conv-stem grid into them (HA), in the
windowed sampling mode (the port of `gedepth_tpu.models.hahi`).

Windowed mode: the reference point of every query is its own grid centre,
offsets are bounded to ±R level pixels by R·tanh(off/R), and the offset
bias starts at the Deformable-DETR grid scaled by R/P. The sampling itself
is `ops.msda.msda`, one launch per attention over all query grids and
levels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.layers import (
    ConvModule, Dropout, linear, sine_positional_encoding)
from gedepth_tpu_torch.ops import msda as msda_ops


def msda_offset_bias(num_heads, num_levels, num_points, scale=1.0):
    """Deformable-DETR sampling-offset bias: per-head unit directions
    scaled by point rank (× scale), flattened (h, L, P, 2)."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= (p + 1) * scale
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttention(nn.Module):
    """Deformable attention, windowed sampling; mmcv parameter names. In
    training, dropout (p = 0.1) follows the output projection, as in the JAX
    package and mmcv."""

    def __init__(self, embed_dims=512, num_heads=8, num_levels=4,
                 num_points=8, window_radius=4, dropout=0.1):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.window_radius = num_points, window_radius
        n = num_heads * num_levels * num_points
        self.sampling_offsets = linear(embed_dims, 2 * n, init="zeros")
        self.attention_weights = linear(embed_dims, n, init="zeros")
        self.value_proj = linear(embed_dims, embed_dims, init="xavier")
        self.output_proj = linear(embed_dims, embed_dims, init="xavier")
        self.dropout = Dropout(dropout)

    def init_params(self, gen):
        bias = msda_offset_bias(self.num_heads, self.num_levels,
                                self.num_points,
                                scale=self.window_radius / self.num_points)
        self.sampling_offsets.bias.copy_(torch.from_numpy(bias))

    def forward(self, query, value, query_pos, spatial_shapes, query_shapes):
        """query (B, Nq, C): the row-major grids `query_shapes`, stacked;
        value (B, Nv, C) flattened over `spatial_shapes`; query_pos is
        added to the query. Returns (B, Nq, C)."""
        B, Nq, C = query.shape
        h, L, P = self.num_heads, self.num_levels, self.num_points
        identity = query
        query = query + query_pos
        value = self.value_proj(value).view(B, -1, h, C // h)
        offsets = self.sampling_offsets(query).view(B, Nq, h, L, P, 2)
        weights = self.attention_weights(query).view(B, Nq, h, L * P)
        weights = weights.softmax(-1).view(B, Nq, h, L, P)
        pos = msda_ops.windowed_positions(offsets, query_shapes,
                                          spatial_shapes, self.window_radius)
        out = msda_ops.msda(value, spatial_shapes, pos, weights,
                            query_shapes, self.window_radius)
        return identity + self.dropout(self.output_proj(out))


class HAHINeck(nn.Module):
    """5-scale neck: [conv stem, 4 Swin levels] -> same shapes out (NCHW).

    hi_min_level: the first Swin level whose tokens query the HI
    self-attention (all levels still serve as values)."""

    def __init__(self, in_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 out_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 embed_dim=512, num_heads=8, num_points=8, sampling="windowed",
                 window_radius=4, hi_min_level=0):
        super().__init__()
        if sampling != "windowed":
            raise NotImplementedError(
                f"neck sampling {sampling!r} is not ported yet (windowed "
                "only)")
        L = len(in_channels) - 1
        if not 0 <= hi_min_level < L:
            raise ValueError(f"hi_min_level {hi_min_level} not in [0, {L})")
        self.embed_dim, self.hi_min_level = embed_dim, hi_min_level
        self.lateral_convs = nn.ModuleList([
            ConvModule(c_in, c_out, 1, use_norm=True, act=F.relu)
            for c_in, c_out in zip(in_channels, out_channels)])
        self.trans_proj = nn.ModuleList([
            ConvModule(c, embed_dim, 1, use_norm=True, act=F.relu)
            for c in out_channels[1:]])
        self.level_embed = nn.Parameter(torch.empty(L, embed_dim))
        self.self_attn = MSDeformAttention(embed_dim, num_heads, L,
                                           num_points, window_radius)
        self.conv_proj = nn.Sequential(
            ConvModule(out_channels[0], embed_dim, 1, use_norm=True,
                       act=F.relu))
        self.multi_att = MSDeformAttention(embed_dim, num_heads, L,
                                           num_points, window_radius)
        self.conv_fusion = nn.Sequential(
            ConvModule(embed_dim + out_channels[0], out_channels[0], 3,
                       use_norm=True, act=F.relu))
        self.trans_fusion = nn.ModuleList([
            ConvModule(c + embed_dim, c, 3, use_norm=True, act=F.relu)
            for c in out_channels[1:]])

    def init_params(self, gen):
        nn.init.normal_(self.level_embed, std=1.0, generator=gen)

    def forward(self, inputs):
        feats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        feat_conv, feats_trans = feats[0], feats[1:]
        spatial_shapes = tuple((f.shape[2], f.shape[3]) for f in feats_trans)
        num_feats = self.embed_dim // 2

        src, pos = [], []
        for i, f in enumerate(feats_trans):
            H_, W_ = f.shape[2:]
            src.append(self.trans_proj[i](f).flatten(2).transpose(1, 2))
            pe = sine_positional_encoding(H_, W_, num_feats, device=f.device)
            pos.append(pe.reshape(1, H_ * W_, -1) + self.level_embed[i])
        src = torch.cat(src, dim=1)
        pos = torch.cat(pos, dim=1)

        lo = self.hi_min_level
        n0 = sum(h_ * w_ for (h_, w_) in spatial_shapes[:lo])
        upd = self.self_attn(src[:, n0:], src, pos[:, n0:], spatial_shapes,
                             spatial_shapes[lo:])
        src = torch.cat([src[:, :n0], upd], dim=1) if n0 else upd

        B, _, Hc, Wc = feat_conv.shape
        query = self.conv_proj(feat_conv).flatten(2).transpose(1, 2)
        qpos = sine_positional_encoding(Hc, Wc, num_feats,
                                        device=query.device)
        fused = self.multi_att(query, src, qpos.reshape(1, Hc * Wc, -1),
                               spatial_shapes, ((Hc, Wc),))
        fused = fused.transpose(1, 2).reshape(B, self.embed_dim, Hc, Wc)
        outs = [self.conv_fusion(torch.cat([fused, feat_conv], dim=1))]
        start = 0
        for i, f in enumerate(feats_trans):
            H_, W_ = f.shape[2:]
            tok = src[:, start:start + H_ * W_].transpose(1, 2).reshape(
                B, self.embed_dim, H_, W_)
            start += H_ * W_
            outs.append(self.trans_fusion[i](torch.cat([f, tok], dim=1)))
        return outs
