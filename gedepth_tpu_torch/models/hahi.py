"""HAHI neck: deformable self-attention over the four Swin levels (HI) and
deformable cross-attention from the conv-stem grid into them (HA), the port
of `gedepth_tpu.models.hahi`.

Sampling modes (how a sample's level-pixel position is formed; the rules
are in `ops.msda`):
  * 'bilinear': the reference (mmcv) semantics, ref + off / (W_l, H_l) with
    learned cross-attention reference points sigmoid(Linear(query_pos));
  * 'nearest': the same locations, one tap floor(loc·size);
  * 'windowed': the reference point of every query is its own grid centre,
    offsets are bounded to ±R level pixels by R·tanh(off/R), and the offset
    bias starts at the Deformable-DETR grid scaled by R/P; no
    `reference_points` layer;
  * 'windowed_compat': the reference parameter tree and formula with the
    displacement from the query's grid centre clamped to ±R level pixels.
The sampling itself is `ops.msda.msda`, one launch per attention over all
query grids and levels, whatever the mode.
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


SAMPLING_MODES = ("bilinear", "nearest", "windowed", "windowed_compat")

# the public name of the JAX package's `models.hahi.compat_delta_px`
compat_delta_px = msda_ops.compat_delta_px


class MSDeformAttention(nn.Module):
    """Deformable attention; mmcv parameter names. In training, dropout
    (p = 0.1) follows the output projection, as in the JAX package and mmcv.

    After a 'windowed_compat' forward, `compat_clamp_mass` holds the share
    of the attention mass whose samples the clamp moved (a 0-dim tensor on
    the device, not synchronised; None in the other modes)."""

    def __init__(self, embed_dims=512, num_heads=8, num_levels=4,
                 num_points=8, window_radius=4, dropout=0.1,
                 sampling="bilinear"):
        super().__init__()
        if sampling not in SAMPLING_MODES:
            raise ValueError(f"sampling {sampling!r} not in {SAMPLING_MODES}")
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points, self.window_radius = num_points, window_radius
        self.sampling = sampling
        self.compat_clamp_mass = None
        n = num_heads * num_levels * num_points
        self.sampling_offsets = linear(embed_dims, 2 * n, init="zeros")
        self.attention_weights = linear(embed_dims, n, init="zeros")
        self.value_proj = linear(embed_dims, embed_dims, init="xavier")
        self.output_proj = linear(embed_dims, embed_dims, init="xavier")
        self.dropout = Dropout(dropout)

    def init_params(self, gen):
        # the windowed rule rescales the bias grid to fill its window
        scale = (self.window_radius / self.num_points
                 if self.sampling == "windowed" else 1.0)
        bias = msda_offset_bias(self.num_heads, self.num_levels,
                                self.num_points, scale=scale)
        self.sampling_offsets.bias.copy_(torch.from_numpy(bias))

    def _positions(self, offsets, weights, reference_points, spatial_shapes,
                   query_shapes):
        """(positions, window hint) of this mode. The hint tells the
        kernels what bounds the positions: windowed and compat positions lie
        within R of their grid centres by construction; exact and nearest
        positions are unbounded and go without."""
        mode, R = self.sampling, self.window_radius
        if mode == "windowed":
            return (msda_ops.windowed_positions(offsets, query_shapes,
                                                spatial_shapes, R),
                    (query_shapes, R))
        if reference_points is None:
            raise ValueError(f"sampling {mode!r} needs reference_points")
        if mode == "windowed_compat":
            pos, delta = msda_ops.compat_positions(
                reference_points, offsets, query_shapes, spatial_shapes, R)
            self.compat_clamp_mass = msda_ops.compat_clamp_mass(
                delta.detach(), weights.detach(), R)
            return pos, (query_shapes, R)
        rule = (msda_ops.exact_positions if mode == "bilinear"
                else msda_ops.nearest_positions)
        return rule(reference_points, offsets, spatial_shapes), ()

    def forward(self, query, value, query_pos, spatial_shapes, query_shapes,
                reference_points=None):
        """query (B, Nq, C): the row-major grids `query_shapes`, stacked;
        value (B, Nv, C) flattened over `spatial_shapes`; query_pos is
        added to the query; reference_points (Nq, L, 2) or (B or 1, Nq, L,
        2) normalised (x, y), unused in windowed mode (the grid centres are
        implied). Returns (B, Nq, C).

        The value keeps the module's dtype (bf16 in a bf16 model); the
        positions and the attention weights are formed in f32 from the
        projections, which is what `ops.msda` takes: a bf16 position on a
        304-pixel level has a quarter-pixel grid."""
        B, Nq, C = query.shape
        h, L, P = self.num_heads, self.num_levels, self.num_points
        identity = query
        query = query + query_pos.to(query.dtype)
        value = self.value_proj(value).view(B, -1, h, C // h)
        offsets = self.sampling_offsets(query).float().view(B, Nq, h, L, P, 2)
        weights = self.attention_weights(query).float().view(B, Nq, h, L * P)
        weights = weights.softmax(-1).view(B, Nq, h, L, P)
        if reference_points is not None:
            reference_points = reference_points.float()
        pos, hint = self._positions(offsets, weights, reference_points,
                                    spatial_shapes, query_shapes)
        out = msda_ops.msda(value, spatial_shapes, pos, weights, *hint)
        return identity + self.dropout(self.output_proj(out))


class HAHINeck(nn.Module):
    """5-scale neck: [conv stem, 4 Swin levels] -> same shapes out (NCHW).

    sampling: one of `SAMPLING_MODES`; every mode but 'windowed' has the
    `reference_points` layer of the reference parameter tree.
    hi_min_level: the first Swin level whose tokens query the HI
    self-attention (all levels still serve as values)."""

    def __init__(self, in_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 out_channels: Sequence[int] = (64, 192, 384, 768, 1536),
                 embed_dim=512, num_heads=8, num_points=8, sampling="bilinear",
                 window_radius=4, hi_min_level=0):
        super().__init__()
        L = len(in_channels) - 1
        if not 0 <= hi_min_level < L:
            raise ValueError(f"hi_min_level {hi_min_level} not in [0, {L})")
        self.embed_dim, self.hi_min_level = embed_dim, hi_min_level
        self.sampling = sampling
        self.lateral_convs = nn.ModuleList([
            ConvModule(c_in, c_out, 1, use_norm=True, act=F.relu)
            for c_in, c_out in zip(in_channels, out_channels)])
        self.trans_proj = nn.ModuleList([
            ConvModule(c, embed_dim, 1, use_norm=True, act=F.relu)
            for c in out_channels[1:]])
        self.level_embed = nn.Parameter(torch.empty(L, embed_dim))
        self.self_attn = MSDeformAttention(embed_dim, num_heads, L,
                                           num_points, window_radius,
                                           sampling=sampling)
        self.conv_proj = nn.Sequential(
            ConvModule(out_channels[0], embed_dim, 1, use_norm=True,
                       act=F.relu))
        if sampling != "windowed":
            # cross-attention reference points sigmoid(Linear(query_pos))
            self.reference_points = linear(embed_dim, 2, init="xavier")
        self.multi_att = MSDeformAttention(embed_dim, num_heads, L,
                                           num_points, window_radius,
                                           sampling=sampling)
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
        windowed = self.sampling == "windowed"

        src, pos = [], []
        for i, f in enumerate(feats_trans):
            H_, W_ = f.shape[2:]
            src.append(self.trans_proj[i](f).flatten(2).transpose(1, 2))
            pe = sine_positional_encoding(H_, W_, num_feats, device=f.device)
            pos.append(pe.reshape(1, H_ * W_, -1).to(self.level_embed.dtype)
                       + self.level_embed[i])
        src = torch.cat(src, dim=1)
        pos = torch.cat(pos, dim=1)

        lo = self.hi_min_level
        n0 = sum(h_ * w_ for (h_, w_) in spatial_shapes[:lo])
        # the self-attention's reference points are the grid centres in
        # every mode; the windowed rule implies them
        ref_self = None if windowed else msda_ops.center_reference_points(
            spatial_shapes, src.device)[n0:]
        upd = self.self_attn(src[:, n0:], src, pos[:, n0:], spatial_shapes,
                             spatial_shapes[lo:], ref_self)
        src = torch.cat([src[:, :n0], upd], dim=1) if n0 else upd

        B, _, Hc, Wc = feat_conv.shape
        query = self.conv_proj(feat_conv).flatten(2).transpose(1, 2)
        qpos = sine_positional_encoding(
            Hc, Wc, num_feats, device=query.device).reshape(1, Hc * Wc, -1)
        ref_q = None
        if not windowed:
            ref_q = torch.sigmoid(self.reference_points(
                qpos.to(query.dtype)))                           # (1, Nq, 2)
            ref_q = ref_q[:, :, None, :].expand(-1, -1, len(spatial_shapes),
                                                -1)
        fused = self.multi_att(query, src, qpos, spatial_shapes,
                               ((Hc, Wc),), ref_q)
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
