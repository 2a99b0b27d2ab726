"""BinsFormer decode head (the port of `gedepth_tpu.models.binsformer`; Li
et al. 2022), NCHW, under the reference's module names
(depth/models/decode_heads/binsformer_head.py with PureMSDEnTransformer and
PixelTransformerDecoder of depth/models/utils/transformer.py), so a
reference `.pth` loads as is:

  skip_proj.{i}                       1x1 ConvModule, BN, LeakyReLU 0.01
  transformer_encoder.level_embeds    (L, C), the encoder's level embeds
  transformer_encoder.encoder.layers.{n}
      .attentions.0                   deformable self-attention (mmcv keys)
      .ffns.0.layers.{0.0,1}          ReLU FFN of 1024
      .norms.{0,1}                    post-norm LayerNorms
  lateral_convs.{j}, output_convs.{j} the FPN: 1x1 BN ReLU, 3x3 BN LeakyReLU
  level_embed.weight                  (L, C), the decoder's level embeds
  query_feat.weight, query_embed.weight  (n_bins + 1, C), class query first
  transformer_decoder.layers.{n}
      .attentions.{0,1}.attn          cross-, then self-attention (torch's
                                      packed in_proj_weight (3C, C))
      .ffns.0.layers.{0.0,1}          ReLU FFN of 2048
      .norms.{0,1,2}
  transformer_decoder.{decoder_norm, bins_embed, mask_embed.layers.{0,1,2},
      class_embed.layers.{0,1,2}}     the prediction heads, shared by all
                                      decoder layers

The forward, as the JAX head's: the levels `trans_index` of the pyramid go
through `skip_proj` and 6 deformable encoder layers over all of them
(the exact sampling rule, every token's grid centre as its reference
point, positions the sine encoding plus the encoder's level embed); the
encoder output is split per level and reversed to coarse -> fine; the FPN
runs over pyramid levels L-1 .. 0, its first top-down input the FINEST
encoder level (the reference appends its outputs to the same list), so
the per-pixel map is at the first pyramid level's resolution (/2 with the
conv stem). The queries cross-attend the encoder levels round robin,
coarse first (decoder layer l reads level l mod L), over 9 post-norm
layers; every layer predicts through the shared heads: softmax bin widths
times (max − min), min_depth prepended, cumulative sum -> edges (B,
n_bins + 1), per-pixel logits <mask embedding, pixel feature>, softmax,
depth = Σ p · centre; the class logits from query 0.

The decoder's attention is flax's `MultiHeadDotProductAttention`: separate
q, k and v projections with bias, the query scaled by 1/sqrt(head dim), the
positional encodings added to query and key only (the value is the raw
memory, or the raw queries in self-attention). It runs as plain products
(the JAX package runs it in XLA, through no Pallas kernel).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gedepth_tpu_torch.models.adabins import MultiheadAttention
from gedepth_tpu_torch.models.hahi import MSDeformAttention
from gedepth_tpu_torch.models.layers import (
    ConvModule, leaky_relu, linear, sine_positional_encoding)
from gedepth_tpu_torch.ops import msda as msda_ops
from gedepth_tpu_torch.ops.resize import resize_bilinear_nchw


class _ReluFFN(nn.Module):
    """Linear -> ReLU -> Linear under mmcv FFN's keys `layers.0.0` and
    `layers.1` (flax `ffn1`, `ffn2`)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(linear(dim, hidden, init="lecun"), nn.ReLU()),
            linear(hidden, dim, init="lecun"))

    def forward(self, x):
        return self.layers(x)


class _EncoderLayer(nn.Module):
    """Deformable-DETR encoder layer, order (self_attn, norm, ffn, norm):
    the deformable attention adds its residual itself."""

    def __init__(self, dim, num_heads, num_levels, ff_dim, num_points):
        super().__init__()
        self.attentions = nn.ModuleList([MSDeformAttention(
            dim, num_heads, num_levels, num_points, dropout=0.0,
            sampling="bilinear")])
        self.ffns = nn.ModuleList([_ReluFFN(dim, ff_dim)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5)
                                    for _ in range(2)])

    def forward(self, x, pe, reference_points, spatial_shapes):
        x = self.norms[0](self.attentions[0](
            x, x, pe, spatial_shapes, spatial_shapes, reference_points))
        return self.norms[1](x + self.ffns[0](x))


class _Attention(nn.Module):
    """mmcv's MultiheadAttention wrapper: the torch-keyed projections under
    `attn`; positional encodings on query and key only."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.attn = MultiheadAttention(dim, num_heads)

    def forward(self, query, key, value, query_pos, key_pos):
        return self.attn(query + query_pos, key + key_pos, value)


class _DecoderLayer(nn.Module):
    """Pixel-decoder layer, order (cross_attn, norm, self_attn, norm, ffn,
    norm), post-norm."""

    def __init__(self, dim, num_heads, ff_dim):
        super().__init__()
        self.attentions = nn.ModuleList([_Attention(dim, num_heads)
                                         for _ in range(2)])
        self.ffns = nn.ModuleList([_ReluFFN(dim, ff_dim)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5)
                                    for _ in range(3)])

    def forward(self, queries, query_pos, memory, memory_pos):
        queries = self.norms[0](queries + self.attentions[0](
            queries, memory, memory, query_pos, memory_pos))
        queries = self.norms[1](queries + self.attentions[1](
            queries, queries, queries, query_pos, query_pos))
        return self.norms[2](queries + self.ffns[0](queries))


class _MLP3(nn.Module):
    """Linear-ReLU, Linear-ReLU, Linear (`layers.{0,1,2}`)."""

    def __init__(self, dim, out):
        super().__init__()
        self.layers = nn.ModuleList([linear(dim, dim, init="lecun"),
                                     linear(dim, dim, init="lecun"),
                                     linear(dim, out, init="lecun")])

    def forward(self, x):
        x = F.relu(self.layers[0](x))
        return self.layers[2](F.relu(self.layers[1](x)))


class _Embedding(nn.Module):
    """A (n, dim) table under the key `weight` (the reference's
    nn.Embedding), drawn from N(0, 1)."""

    def __init__(self, n, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, dim))

    def init_params(self, gen):
        nn.init.normal_(self.weight, std=1.0, generator=gen)


class _Encoder(nn.Module):
    """PureMSDEnTransformer's keys: `level_embeds` and `encoder.layers`."""

    def __init__(self, dim, num_levels, num_layers, num_heads, ff_dim,
                 num_points):
        super().__init__()
        self.level_embeds = nn.Parameter(torch.zeros(num_levels, dim))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            _EncoderLayer(dim, num_heads, num_levels, ff_dim, num_points)
            for _ in range(num_layers)])

    def init_params(self, gen):
        nn.init.normal_(self.level_embeds, std=1.0, generator=gen)


class _Decoder(nn.Module):
    """PixelTransformerDecoder's keys: the layers and the shared heads."""

    def __init__(self, dim, num_layers, num_heads, ff_dim, class_num):
        super().__init__()
        self.layers = nn.ModuleList([_DecoderLayer(dim, num_heads, ff_dim)
                                     for _ in range(num_layers)])
        self.decoder_norm = nn.LayerNorm(dim, eps=1e-5)
        self.bins_embed = linear(dim, 1, init="lecun")
        self.mask_embed = _MLP3(dim, dim)
        self.class_embed = _MLP3(dim, class_num) if class_num else None


class BinsFormerHead(nn.Module):
    """inputs: the pyramid fine -> coarse, NCHW (the zoo's 5 levels: the
    conv stem and the four Swin stages). forward returns a list, one dict a
    decoder layer (the last is the final prediction): depth (B, 1, h, w)
    at the first level's resolution, bin_edges (B, n_bins + 1) and, when
    `classify`, class_logits (B, class_num)."""

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 256,
                 n_bins: int = 64, trans_index: Sequence[int] = (2, 3, 4),
                 num_encoder_layers: int = 6, num_decoder_layers: int = 9,
                 num_heads: int = 8, enc_num_points: int = 8,
                 enc_ff_dim: int = 1024, dec_ff_dim: int = 2048,
                 classify: bool = True, class_num: int = 25,
                 min_depth: float = 1e-3, max_depth: float = 10.0):
        super().__init__()
        cd, L = conv_dim, len(trans_index)
        self.conv_dim, self.trans_index = cd, tuple(trans_index)
        self.classify = classify
        self.min_depth, self.max_depth = min_depth, max_depth
        self.skip_proj = nn.ModuleList([
            ConvModule(in_channels[i], cd, 1, use_norm=True, act=leaky_relu)
            for i in self.trans_index])
        self.transformer_encoder = _Encoder(cd, L, num_encoder_layers,
                                            num_heads, enc_ff_dim,
                                            enc_num_points)
        # the FPN, top-down: pyramid levels L-1 .. 0
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels[i], cd, 1, use_norm=True, act=F.relu)
            for i in range(L - 1, -1, -1)])
        self.output_convs = nn.ModuleList([
            ConvModule(cd, cd, 3, use_norm=True, act=leaky_relu)
            for _ in range(L)])
        nq = n_bins + (1 if classify else 0)
        self.level_embed = _Embedding(L, cd)
        self.query_feat = _Embedding(nq, cd)
        self.query_embed = _Embedding(nq, cd)
        self.transformer_decoder = _Decoder(cd, num_decoder_layers,
                                            num_heads, dec_ff_dim,
                                            class_num if classify else 0)

    def forward(self, inputs, all_layers=None):
        """all_layers: predict at every decoder layer (default: in training,
        where the auxiliary losses read them); otherwise at the last only,
        and the list holds that one dict."""
        if all_layers is None:
            all_layers = self.training
        cd, L = self.conv_dim, len(self.trans_index)
        feats = [proj(inputs[i])
                 for proj, i in zip(self.skip_proj, self.trans_index)]
        B, dtype, device = feats[0].shape[0], feats[0].dtype, feats[0].device
        shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        raw_pes = [sine_positional_encoding(h, w, cd // 2, device=device)
                   .reshape(1, h * w, cd).to(dtype) for h, w in shapes]
        enc = self.transformer_encoder
        src = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)
        src_pe = torch.cat([pe + enc.level_embeds[i]
                            for i, pe in enumerate(raw_pes)], 1)
        ref = msda_ops.center_reference_points(shapes, device)
        for layer in enc.encoder.layers:
            src = layer(src, src_pe, ref, shapes)

        # split per level, coarse -> fine; the FPN appends to the same list
        out = []
        for tok, (h, w) in zip(src.split([h * w for h, w in shapes], 1),
                               shapes):
            out.append(tok.transpose(1, 2).reshape(B, cd, h, w))
        out = out[::-1]
        for j, idx in enumerate(range(L - 1, -1, -1)):
            lat = self.lateral_convs[j](inputs[idx])
            y = lat + resize_bilinear_nchw(out[-1], lat.shape[2:],
                                           align_corners=True)
            out.append(self.output_convs[j](y))
        per_pixel = out[-1]
        per_level = [(f.flatten(2).transpose(1, 2),
                      pe + self.level_embed.weight[i])
                     for i, (f, pe) in enumerate(zip(out[:L],
                                                     raw_pes[::-1]))]

        dec = self.transformer_decoder
        queries = self.query_feat.weight[None].expand(B, -1, -1)
        query_pos = self.query_embed.weight[None].expand(B, -1, -1)
        last = len(dec.layers) - 1
        outputs = []
        for n, layer in enumerate(dec.layers):
            memory, memory_pos = per_level[n % L]
            queries = layer(queries, query_pos, memory, memory_pos)
            if all_layers or n == last:
                outputs.append(self._predict(queries, per_pixel))
        return outputs

    def _predict(self, queries, per_pixel):
        dec = self.transformer_decoder
        q = dec.decoder_norm(queries)
        out = {}
        if self.classify:
            out["class_logits"] = dec.class_embed(q[:, 0])
            q = q[:, 1:]
        widths = torch.softmax(dec.bins_embed(q)[..., 0], dim=1)
        widths = F.pad((self.max_depth - self.min_depth) * widths, (1, 0),
                       value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centres = 0.5 * (edges[:, :-1] + edges[:, 1:])
        logits = torch.einsum("bchw,bqc->bqhw", per_pixel,
                              dec.mask_embed(q))
        probs = torch.softmax(logits, dim=1)
        out["depth"] = (probs * centres[:, :, None, None]).sum(
            dim=1, keepdim=True)
        out["bin_edges"] = edges
        return out
