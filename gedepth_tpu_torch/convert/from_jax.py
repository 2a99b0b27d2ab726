"""Carry a JAX `GEDepth` variable tree over to the port's state_dict.

`state_dict_from_flax(params, batch_stats)` takes the flax variables as
nested dicts of arrays (numpy or anything `np.asarray` reads) and returns a
state_dict that the port's `GEDepth` loads with `strict=True`:

  * names follow the reference PyTorch keys (the rules of
    tests/test_parity_torch.py `_flax_to_torch_name`/`_convmodule_name`);
  * conv kernels go HWIO -> OIHW, dense kernels are transposed, LayerNorm
    and BatchNorm `scale` become `weight`, BatchNorm `mean`/`var` become
    `running_mean`/`running_var` (plus a zero `num_batches_tracked`);
  * scanned Swin stages (`stage{i}_pairs`, swin_scan=True) are unstacked to
    per-block entries first, as `gedepth_tpu.models.swin.unstack_swin_params`
    does.

The same rules carry the zoo's `ZooDepther` (ResNet `backbone/conv1`,
`bn1`, `layer{i}_block{b}/convbn{n}/{conv,bn}` and `.../downsample/{conv,
bn}` to mmseg's `backbone.layer{i}.{b}.conv{n}` / `bn{n}` /
`downsample.{0,1}`; the BTS head's flax modules to the reference
bts_head.py names) and the stage-1 ground-mask model
(`models.pretrain.GroundMaskPretrain`: `backbone`, `neck`, `fuse`,
`classifier`). The trees differ with the model: only the windowed neck lacks
`neck/reference_points` (the cross-attention's learned reference points,
`neck.reference_points.{weight,bias}` in the reference), a model without
ground embedding has no `pe_mask_neck` and a 3-channel patch embed, and only
the adaptive one has `dynamic_pe_neck`. `load_flax_variables` loads a tree
into a model strictly and says which of the two, sampling mode or PE
variant, does not match when the keys differ.

The zoo's ViT, DPT head, EfficientNets and AdaBins head map leaf by leaf
too (`_zoo2_torch_name`, `_zoo2_flax_module`), with two exceptions that map
several leaves to one tensor (`_fuse_flax`, `_split_torch`): flax's
attention keeps q, k, v and the output projection as kernels (C, heads,
head dim) and (heads, head dim, C), where the port packs q, k and v into one
(3C, C) weight (the ViT's `attn.qkv`, AdaBins' `self_attn.in_proj_weight`);
and the DPT's `_Deconv` is a Dense (C, k·k·F) ordered (k_y, k_x, F) with a
bias per sub-pixel, where the port's transposed conv keeps a weight (C, F,
k, k) and a bias (F, k, k). Going back to flax needs the head count: 4 in
AdaBins' encoder, max(1, C // 64) in the ViT (the zoo's rule).
The DPT head's `conv_depth` is a leaf name of DenseDepth's head too: a tree
whose decode head has `reassemble0` is read as DPT's.

BinsFormer's head maps as `_bins_torch_name` / `_bins_flax_module` say (its
Swin is GEDepth's): the flax modules `skip_proj{i}`, `lateral{j}`,
`output{j}` (ConvModules), `encoder{n}` (`self_attn`, `ffn1`, `ffn2`,
`norm1`, `norm2`), `decoder{n}` (`cross_attn`, `self_attn`, `ffn1`, `ffn2`,
`norm1`-`norm3`), `decoder_norm`, `bins_embed`, `mask_embed` and
`class_embed` (`layers{k}`), and the tables `enc_level_embed`,
`level_embed`, `query_feat` and `query_embed`, to the reference's
`skip_proj.{i}`, `lateral_convs.{j}`, `output_convs.{j}`,
`transformer_encoder.{level_embeds, encoder.layers.{n}.{attentions.0,
ffns.0.layers.{0.0,1}, norms.{0,1}}}`, `transformer_decoder.{layers.{n}.
{attentions.{0,1}.attn, ffns.0, norms.{0,1,2}}, decoder_norm, bins_embed,
mask_embed.layers.{k}, class_embed.layers.{k}}`, `level_embed.weight`,
`query_feat.weight` and `query_embed.weight`. The decoder's flax attention
kernels (C, 8, C/8) and (8, C/8, C) are packed into torch's in_proj (3C, C)
and out_proj as AdaBins' are, with BinsFormer's 8 heads going back.

The seg model's HRNet maps to mmcv's names (`_seg_torch_name`,
`_seg_flax_module`): `stem{n}` to `conv{n}`/`bn{n}`, `t{s}_adapt{i}` and
`t{s}_new{i}` to `transition{s-1}.{i}` and `.{i}.0`,
`stage{s}_module{m}/branch{i}_block{b}` to `stage{s}.{m}.branches.{i}.{b}`,
`fuse/up{i}_{j}` and `fuse/down{i}_{j}_{k}` to `fuse_layers.{i}.{j}` and
`.{i}.{j}.{k}`; its heads' `conv{i}` ConvModules to `convs.{i}`. A DDRNet
tree (one with `backbone/spp`) maps to the reference's ddrnet.py names;
going back, `backbone_kind` tells HRNet and DDRNet keys apart as the JAX
converter does.

The experiment heads of `models.experiment_heads` (`GuidanceHead`,
`PacConv`, `ASNDepthHead`) and `models.asn` (`ASNSegHead`,
`ASNDepthHeadV2`) are trees of their own, whose top modules (`conv0`,
`up{i}`, `guide`, `pac`, `conv_depth`; `fuse{i}`, `bn{i}`, `cls_{key}`;
`depth_head`, `guidance_head`; a `PacConv`'s bare `kernel` and `bias`) no
model has at its top. A tree whose every top name is one of these
(`is_head_tree`, checked once for the whole tree) takes the head rule
alone: its port keys are the flax module paths with a ConvModule's
`Conv_0` as `conv` (`_head_torch_name`, `_head_flax_module`). A model's
key that no other rule maps still raises KeyError.

`flax_variables_from_state_dict` goes the other way, in the per-block Swin
layout (the JAX package's `load_params_only` adapts it to either
`swin_scan`); `train.checkpoint.save_params_only` writes it as the JAX
package's `.npz`.
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def unstack_swin_params(backbone: Mapping) -> dict:
    """Scanned-pair backbone tree -> per-block tree: the stacked entries of
    `stage{i}_pairs/block{j}` become `stage{i}_block{2p+j}`."""
    out = {k: v for k, v in backbone.items()
           if not (k.startswith("stage") and k.endswith("_pairs"))}
    for k, pairs in backbone.items():
        if not (k.startswith("stage") and k.endswith("_pairs")):
            continue
        i = k[len("stage"):-len("_pairs")]
        n_pairs = next(_flatten(pairs["block0"]))[1].shape[0]
        for p in range(n_pairs):
            for j in range(2):
                out[f"stage{i}_block{2 * p + j}"] = _take(pairs[f"block{j}"],
                                                          p)
    return out


def _take(tree, p):
    return {k: (_take(v, p) if isinstance(v, Mapping) else np.asarray(v)[p])
            for k, v in tree.items()}


_WB = {"kernel": "weight", "scale": "weight", "bias": "bias",
       "mean": "running_mean", "var": "running_var"}


def _convmodule(base, names):
    return f"{base}.{'conv' if names[0] == 'Conv_0' else 'bn'}.{_WB[names[-1]]}"


# the BTS head's AtrousConv children inside `atrous_conv` (bts_head.py)
_ATROUS = {"first_bn": "first_bn", "conv1x1": "aconv_sequence.1",
           "bn": "aconv_sequence.2", "conv3x3": "aconv_sequence.4"}
_ATROUS_INV = {v: k for k, v in _ATROUS.items()}


def _zoo_torch_name(names, leaf):
    """Reference key of a ResNet or BTS-head leaf path, or None."""
    top, sub = names[0], names[1]
    if top == "backbone":
        if sub in ("conv1", "bn1"):
            return f"backbone.{sub}.{leaf}"
        m = re.fullmatch(r"layer(\d+)_block(\d+)", sub)
        if m:
            base = f"backbone.layer{m.group(1)}.{m.group(2)}"
            if names[2] == "downsample":
                idx = 0 if names[3] == "conv" else 1
                return f"{base}.downsample.{idx}.{leaf}"
            return f"{base}.{names[3]}{names[2][len('convbn'):]}.{leaf}"
        return None
    if top != "decode_head":
        return None
    if re.fullmatch(r"upconv\d", sub):
        return f"decode_head.{sub}.conv.{leaf}"
    if re.fullmatch(r"bn\d(_2)?", sub):
        return f"decode_head.{sub}.{leaf}"
    if re.fullmatch(r"conv[1-9]", sub) or sub == "daspp_conv":
        return f"decode_head.{sub}.0.{leaf}"
    if re.fullmatch(r"daspp_\d+", sub):
        return f"decode_head.{sub}.atrous_conv.{_ATROUS[names[2]]}.{leaf}"
    if re.fullmatch(r"reduc\d+x\d+", sub):
        conv = names[2] + ("" if names[2] == "plane_params" else ".0")
        return f"decode_head.{sub}.reduc.{conv}.{leaf}"
    return None


def _zoo_flax_module(p):
    """Flax module path of a ResNet or BTS-head reference key without its
    leaf, or None (the inverse of `_zoo_torch_name`)."""
    if p[0] == "backbone":
        if p[1] in ("conv1", "bn1"):
            return ("backbone", p[1])
        m = re.fullmatch(r"layer(\d+)", p[1])
        if m:
            block = ("backbone", f"layer{m.group(1)}_block{p[2]}")
            if p[3] == "downsample":
                return block + ("downsample",
                                "conv" if p[4] == "0" else "bn")
            kind, n = re.fullmatch(r"(conv|bn)(\d)", p[3]).groups()
            return block + (f"convbn{n}", kind)
        return None
    if p[0] != "decode_head":
        return None
    if re.fullmatch(r"upconv\d", p[1]):
        return ("decode_head", p[1], "conv")
    if re.fullmatch(r"bn\d(_2)?", p[1]):
        return ("decode_head", p[1])
    if re.fullmatch(r"conv[1-9]", p[1]) or p[1] == "daspp_conv":
        return ("decode_head", p[1])
    if re.fullmatch(r"daspp_\d+", p[1]):
        part = ".".join(p[3:-1])
        return ("decode_head", p[1], _ATROUS_INV[part])
    if re.fullmatch(r"reduc\d+x\d+", p[1]):
        return ("decode_head", p[1], p[3])
    return None


_FFN = {"Dense_0": "layers.0.0", "Dense_1": "layers.1"}
_DPT_HEAD = {"head_conv1": "0", "head_conv2": "2", "conv_depth": "4"}
_REGRESSOR = {"regressor0": "0", "regressor1": "2", "regressor2": "4"}
_TIMM = "backbone.original_model"
_BINS_ENC = "decode_head.transformer_encoder"
_BINS_DEC = "decode_head.transformer_decoder"
BINSFORMER_HEADS = 8
# BinsFormer's tables: flax name -> port key
_BINS_TABLES = {"enc_level_embed": f"{_BINS_ENC}.level_embeds",
                "level_embed": "decode_head.level_embed.weight",
                "query_feat": "decode_head.query_feat.weight",
                "query_embed": "decode_head.query_embed.weight"}
_BINS_TABLES_INV = {v: k for k, v in _BINS_TABLES.items()}
_BINS_CONVS = {"skip_proj": "skip_proj", "lateral": "lateral_convs",
               "output": "output_convs"}
_BINS_CONVS_INV = {v: k for k, v in _BINS_CONVS.items()}
_BINS_LAYER = {"ffn1": "ffns.0.layers.0.0", "ffn2": "ffns.0.layers.1",
               "norm1": "norms.0", "norm2": "norms.1", "norm3": "norms.2"}
_BINS_LAYER_INV = {v: k for k, v in _BINS_LAYER.items()}


def _bins_torch_name(names, leaf):
    """Port key of a BinsFormer-head leaf path, or None; a leaf of the
    decoder's attention names the packed tensor that holds it (the packing
    itself is `_fuse_flax`'s)."""
    if names[0] != "decode_head":
        return None
    sub = names[1]
    if sub in _BINS_TABLES and len(names) == 2:
        return _BINS_TABLES[sub]
    m = re.fullmatch(r"(skip_proj|lateral|output)(\d+)", sub)
    if m:
        return _convmodule(
            f"decode_head.{_BINS_CONVS[m.group(1)]}.{m.group(2)}", names[2:])
    m = re.fullmatch(r"(encoder|decoder)(\d+)", sub)
    if m:
        base = (f"{_BINS_ENC}.encoder.layers.{m.group(2)}"
                if m.group(1) == "encoder"
                else f"{_BINS_DEC}.layers.{m.group(2)}")
        if names[2] in _BINS_LAYER:
            return f"{base}.{_BINS_LAYER[names[2]]}.{leaf}"
        if m.group(1) == "encoder" and names[2] == "self_attn":
            return f"{base}.attentions.0.{names[3]}.{leaf}"
        if names[2] in ("cross_attn", "self_attn"):
            # the packed tensor that holds this leaf (`_fuse_flax`)
            att = f"{base}.attentions.{int(names[2] == 'self_attn')}.attn"
            if names[3] == "out":
                return f"{att}.out_proj.{leaf}"
            return f"{att}.in_proj_{leaf}"
        return None
    if sub in ("decoder_norm", "bins_embed"):
        return f"{_BINS_DEC}.{sub}.{leaf}"
    if sub in ("mask_embed", "class_embed"):
        return f"{_BINS_DEC}.{sub}.layers.{names[2][len('layers'):]}.{leaf}"
    return None


def _bins_flax_module(p):
    """Flax module path of a BinsFormer-head port key without its leaf, or
    None (the inverse of `_bins_torch_name`)."""
    if p[0] != "decode_head":
        return None
    if p[1] in _BINS_CONVS_INV:
        return ("decode_head", f"{_BINS_CONVS_INV[p[1]]}{p[2]}",
                "Conv_0" if p[3] == "conv" else "BatchNorm_0")
    if p[1] == "transformer_encoder" and p[2] == "encoder":
        block = ("decode_head", f"encoder{p[4]}")
        if p[5] == "attentions":
            return block + ("self_attn", p[7])
        return block + (_BINS_LAYER_INV[".".join(p[5:-1])],)
    if p[1] == "transformer_decoder":
        if p[2] == "layers":
            return ("decode_head", f"decoder{p[3]}",
                    _BINS_LAYER_INV[".".join(p[4:-1])])
        if p[2] in ("decoder_norm", "bins_embed"):
            return ("decode_head", p[2])
        if p[2] in ("mask_embed", "class_embed"):
            return ("decode_head", p[2], f"layers{p[4]}")
    return None

_PT = "decode_head.adaptive_bins_layer.patch_transformer"
# the transposed convs of the DPT reassemble blocks: layer index -> factor
DECONV_FACTORS = {0: 4, 1: 2}
ADABINS_HEADS = 4


def _zoo2_torch_name(names, leaf, dpt=False):
    """Port key of a ViT, DPT-head, EfficientNet or AdaBins-head leaf path,
    or None (also for the leaves `_fuse_flax` takes)."""
    top, sub = names[0], names[1]
    if top == "backbone":
        if sub in ("cls_token", "pos_embed"):
            return f"backbone.{sub}"
        if sub == "patch_embed" and len(names) == 3:
            return f"backbone.patch_embed.{leaf}"
        m = re.fullmatch(r"block(\d+)", sub)
        if m:
            base = f"backbone.blocks.{m.group(1)}"
            if names[2] in ("ln1", "ln2"):
                return f"{base}.{names[2]}.{leaf}"
            if names[2] == "ffn":
                return f"{base}.ffn.{_FFN[names[3]]}.{leaf}"
            return None
        if sub == "stem":
            return f"backbone.stem.{names[2]}.{leaf}"
        m = re.fullmatch(r"s(\d+)_b(\d+)", sub)
        if m:
            base = f"backbone.blocks.{m.group(1)}.{m.group(2)}"
            if names[2] in ("se_reduce", "se_expand"):
                return f"{base}.{names[2]}.{leaf}"
            return f"{base}.{names[2]}.{names[3]}.{leaf}"
        if sub in ("conv_stem", "conv_head") and names[2] == "conv":
            return f"{_TIMM}.{sub}.{leaf}"
        if sub == "bn1" and names[2] == "bn":
            return f"{_TIMM}.bn1.{leaf}"
        m = re.fullmatch(r"blocks(\d+)_(\d+)", sub)
        if m:
            base = f"{_TIMM}.blocks.{m.group(1)}.{m.group(2)}"
            if names[2] == "se":
                return f"{base}.se.{names[3]}.{leaf}"
            return f"{base}.{names[2]}.{leaf}"
        return None
    if top != "decode_head":
        return None
    m = re.fullmatch(r"reassemble(\d)", sub)
    if m:
        base = "decode_head.reassemble_blocks"
        if names[2] == "readout":
            return f"{base}.readout_projects.{m.group(1)}.0.{leaf}"
        if names[2] == "proj":
            return f"{base}.projects.{m.group(1)}.conv.{leaf}"
        if names[2] == "resize" and len(names) == 4:
            return f"{base}.resize_layers.{m.group(1)}.{leaf}"
        return None
    m = re.fullmatch(r"channel_proj(\d)", sub)
    if m:
        return f"decode_head.convs.{m.group(1)}.conv.{leaf}"
    m = re.fullmatch(r"fusion(\d)", sub)
    if m:
        # the reference counts the fusion blocks from the deepest map
        base = f"decode_head.fusion_blocks.{3 - int(m.group(1))}"
        if names[2] == "out":
            return f"{base}.project.conv.{leaf}"
        return f"{base}.res_conv_unit{names[2][-1]}.{names[3]}.conv.{leaf}"
    if sub == "project":
        return f"decode_head.project.conv.{leaf}"
    if sub in ("head_conv1", "head_conv2") or (dpt and sub == "conv_depth"):
        return f"decode_head.conv_depth.head.{_DPT_HEAD[sub]}.{leaf}"
    if sub == "decode_final_conv":
        return f"decode_head.decode_final_conv.{leaf}"
    if sub == "conv_out":
        return f"decode_head.conv_out.0.{leaf}"
    if sub == "adaptive_bins_layer":
        base = "decode_head.adaptive_bins_layer"
        if names[2] == "conv3x3":
            return f"{base}.conv3x3.{leaf}"
        if names[2] in _REGRESSOR:
            return f"{base}.regressor.{_REGRESSOR[names[2]]}.{leaf}"
        if names[3] == "positional_encodings":
            return f"{_PT}.positional_encodings"
        if names[3] == "embedding_convPxP":
            return f"{_PT}.embedding_convPxP.{leaf}"
        m = re.fullmatch(r"layer(\d+)", names[3])
        if m and names[4] != "self_attn":
            return (f"{_PT}.transformer_encoder.layers.{m.group(1)}."
                    f"{names[4]}.{leaf}")
    return None


def _zoo2_flax_module(p):
    """Flax module path of a ViT, DPT-head, EfficientNet or AdaBins-head
    port key without its leaf, or None (the inverse of
    `_zoo2_torch_name`)."""
    if p[0] == "backbone":
        if p[1] in ("cls_token", "pos_embed"):
            return ("backbone",)
        if p[1] == "patch_embed" and len(p) == 3:
            return ("backbone", "patch_embed")
        if p[1] == "stem":
            return ("backbone", "stem", p[2])
        if p[1] == "blocks" and p[3].isdigit():          # EfficientNet
            block = ("backbone", f"s{p[2]}_b{p[3]}")
            if p[4] in ("se_reduce", "se_expand"):
                return block + (p[4],)
            return block + (p[4], p[5])
        if p[1] == "blocks":                             # ViT
            block = ("backbone", f"block{p[2]}")
            if p[3] in ("ln1", "ln2"):
                return block + (p[3],)
            if p[3] == "ffn":
                return block + ("ffn", "Dense_0" if p[5] == "0"
                                else "Dense_1")
            return None
        if p[1] == "original_model":
            q = p[2:]
            if q[0] in ("conv_stem", "conv_head"):
                return ("backbone", q[0], "conv")
            if q[0] == "bn1":
                return ("backbone", "bn1", "bn")
            if q[0] == "blocks":
                block = ("backbone", f"blocks{q[1]}_{q[2]}")
                if q[3] == "se":
                    return block + ("se", q[4])
                return block + (q[3], "conv" if q[3].startswith("conv")
                                else "bn")
        return None
    if p[0] != "decode_head":
        return None
    if p[1] == "reassemble_blocks":
        block = ("decode_head", f"reassemble{p[3]}")
        if p[2] == "readout_projects":
            return block + ("readout",)
        if p[2] == "projects":
            return block + ("proj",)
        if p[2] == "resize_layers" and p[3] == "3":
            return block + ("resize",)
        return None
    if p[1] == "convs":
        return ("decode_head", f"channel_proj{p[2]}")
    if p[1] == "fusion_blocks":
        block = ("decode_head", f"fusion{3 - int(p[2])}")
        if p[3] == "project":
            return block + ("out",)
        return block + (f"rcu{p[3][-1]}", p[4])
    if p[1] == "project":
        return ("decode_head", "project")
    if p[1] == "conv_depth" and p[2] == "head":
        inverse = {v: k for k, v in _DPT_HEAD.items()}
        return ("decode_head", inverse[p[3]])
    if p[1] in ("decode_final_conv", "conv_out"):
        return ("decode_head", p[1])
    if p[1] == "adaptive_bins_layer":
        base = ("decode_head", "adaptive_bins_layer")
        if p[2] == "conv3x3":
            return base + ("conv3x3",)
        if p[2] == "regressor":
            inverse = {v: k for k, v in _REGRESSOR.items()}
            return base + (inverse[p[3]],)
        base += ("patch_transformer",)
        if p[3] == "positional_encodings":
            return base
        if p[3] == "embedding_convPxP":
            return base + ("embedding_convPxP",)
        if p[3] == "transformer_encoder" and p[6] != "self_attn":
            return base + (f"layer{p[5]}", p[6])
    return None


def _fuse_flax(leaves):
    """(port entries, the other leaves) of a flattened flax tree: the
    attention leaves packed into the port's q/k/v weights and the DPT's
    `_Deconv` Dense into its transposed conv's weight and bias."""
    out, rest, groups = {}, [], {}
    for names, arr in leaves:
        if (len(names) >= 3
                and names[-3] in ("attn", "self_attn", "cross_attn")
                and names[-2] in ("query", "key", "value", "out")):
            groups.setdefault(names[:-2], {})[names[-2:]] = arr
        elif (len(names) == 5 and names[0] == "decode_head"
              and names[2:4] == ("resize", "dense")):
            i = int(names[1][len("reassemble"):])
            f = DECONV_FACTORS[i]
            key = f"decode_head.reassemble_blocks.resize_layers.{i}."
            if names[4] == "kernel":
                c = arr.shape[0]
                out[key + "weight"] = arr.reshape(c, f, f, -1).transpose(
                    0, 3, 1, 2)
            else:
                out[key + "bias"] = arr.reshape(f, f, -1).transpose(2, 0, 1)
        else:
            rest.append((names, arr))
    for prefix, g in groups.items():
        c = g[("out", "bias")].shape[0]
        qkv_w = np.concatenate([g[(n, "kernel")].reshape(c, c).T
                                for n in ("query", "key", "value")])
        qkv_b = np.concatenate([g[(n, "bias")].reshape(c)
                                for n in ("query", "key", "value")])
        out_w = g[("out", "kernel")].reshape(c, c).T
        if prefix[0] == "backbone":                      # ViT block
            base = f"backbone.blocks.{prefix[1][len('block'):]}.attn"
            names = ("qkv.weight", "qkv.bias", "proj.weight", "proj.bias")
        elif prefix[1].startswith("decoder"):           # BinsFormer decoder
            base = (f"{_BINS_DEC}.layers.{prefix[1][len('decoder'):]}."
                    f"attentions.{0 if prefix[2] == 'cross_attn' else 1}.attn")
            names = ("in_proj_weight", "in_proj_bias", "out_proj.weight",
                     "out_proj.bias")
        else:                                            # AdaBins encoder
            base = (f"{_PT}.transformer_encoder.layers."
                    f"{prefix[3][len('layer'):]}.self_attn")
            names = ("in_proj_weight", "in_proj_bias", "out_proj.weight",
                     "out_proj.bias")
        for n, v in zip(names, (qkv_w, qkv_b, out_w, g[("out", "bias")])):
            out[f"{base}.{n}"] = v
    return out, rest


def _split_torch(key, arr):
    """[(flax path, array)] of a port entry that `_fuse_flax` packs, or
    None for any other key (the inverse of `_fuse_flax`)."""
    p = key.split(".")
    m = re.fullmatch(r"decode_head\.reassemble_blocks\.resize_layers\."
                     r"([01])\.(weight|bias)", key)
    if m:
        path = ("decode_head", f"reassemble{m.group(1)}", "resize", "dense")
        if m.group(2) == "weight":
            return [(path + ("kernel",), arr.transpose(0, 2, 3, 1).reshape(
                arr.shape[0], -1))]
        return [(path + ("bias",), arr.transpose(1, 2, 0).reshape(-1))]
    if key.startswith("backbone.blocks.") and p[3] == "attn":
        base = ("backbone", f"block{p[2]}", "attn")
        leaf = ".".join(p[4:])
    elif key.startswith(f"{_BINS_DEC}.layers.") and p[4] == "attentions":
        base = ("decode_head", f"decoder{p[3]}",
                "cross_attn" if p[5] == "0" else "self_attn")
        leaf = {"in_proj_weight": "qkv.weight", "in_proj_bias": "qkv.bias",
                "out_proj.weight": "proj.weight",
                "out_proj.bias": "proj.bias"}[".".join(p[7:])]
    elif key.startswith(f"{_PT}.transformer_encoder.") and p[6] == "self_attn":
        base = ("decode_head", "adaptive_bins_layer", "patch_transformer",
                f"layer{p[5]}", "self_attn")
        leaf = {"in_proj_weight": "qkv.weight", "in_proj_bias": "qkv.bias",
                "out_proj.weight": "proj.weight",
                "out_proj.bias": "proj.bias"}[".".join(p[7:])]
    else:
        return None
    c = arr.shape[-1] if leaf != "qkv.bias" else arr.shape[0] // 3
    if base[0] == "backbone":
        heads = max(1, c // 64)
    else:
        heads = (BINSFORMER_HEADS if base[1].startswith("decoder")
                 else ADABINS_HEADS)
    hd = c // heads
    if leaf == "qkv.weight":
        return [(base + (n, "kernel"), w.T.reshape(c, heads, hd))
                for n, w in zip(("query", "key", "value"),
                                np.split(arr, 3))]
    if leaf == "qkv.bias":
        return [(base + (n, "bias"), b.reshape(heads, hd))
                for n, b in zip(("query", "key", "value"), np.split(arr, 3))]
    if leaf == "proj.weight":
        return [(base + ("out", "kernel"), arr.T.reshape(heads, hd, c))]
    return [(base + ("out", "bias"), arr)]


_CB = {"conv": "0", "bn": "1"}
_CB_INV = {v: k for k, v in _CB.items()}
# DDRNet's conv-BN Sequentials (ddrnet.py names), and its stem and `down4`
# Sequentials: flax module -> (Sequential, index of the conv, of the BN)
_DDR_SEQ = ("compression3_1", "compression3_2", "compression4", "down3_1",
            "down3_2", "out_conv")
_DDR_PAIRS = {"stem1": ("conv1", "0", "1"), "stem2": ("conv1", "3", "4"),
              "down4_a": ("down4", "0", "1"), "down4_b": ("down4", "3", "4")}
_DDR_LAYER = r"(layer\d(?:_\d)?_?)"


def _block_leaf(base, names, leaf):
    """A residual block's leaf (`convbn{n}/{conv,bn}` or
    `downsample/{conv,bn}`) under the port key `base`."""
    if names[0] == "downsample":
        return f"{base}.downsample.{_CB[names[1]]}.{leaf}"
    return f"{base}.{names[1]}{names[0][len('convbn'):]}.{leaf}"


def _seg_torch_name(names, leaf, ddr=False):
    """Port key of a leaf of the seg heads (`aux_head`, `ocr_head`), of an
    HRNet (`stem{n}`, `t{s}_adapt{i}`, `t{s}_new{i}`, `stage{s}_module{m}`)
    or, with ddr, of a DDRNet backbone; None for any other leaf (an
    HRNet's or DDRNet's `layer1_block{b}` is the ResNet rule's)."""
    top, sub = names[0], names[1]
    if top in ("aux_head", "ocr_head"):
        if sub == "conv_seg" or sub.endswith("_proj"):
            return f"{top}.{sub}.{leaf}"
        m = re.fullmatch(r"conv(\d+)", sub)
        return _convmodule(f"{top}.convs.{m.group(1)}" if m
                           else f"{top}.{sub}", names[2:])
    if top != "backbone":
        return None
    if ddr:
        if sub in _DDR_PAIRS:
            seq, conv, bn = _DDR_PAIRS[sub]
            return f"backbone.{seq}.{conv if names[2] == 'conv' else bn}.{leaf}"
        if sub in _DDR_SEQ:
            return f"backbone.{sub}.{_CB[names[2]]}.{leaf}"
        if sub == "spp":
            pooled = re.fullmatch(r"scale[1-9]", names[2]) is not None
            idx = (3 if names[3] == "conv" else 1) if pooled else (
                2 if names[3] == "conv" else 0)
            return f"backbone.spp.{names[2]}.{idx}.{leaf}"
        m = re.fullmatch(_DDR_LAYER + r"_block(\d+)", sub)
        if m and not re.fullmatch(r"layer\d", m.group(1)):
            return _block_leaf(f"backbone.{m.group(1)}.{m.group(2)}",
                               names[2:], leaf)
        return None
    m = re.fullmatch(r"stem(\d)", sub)
    if m:
        return f"backbone.{names[2]}{m.group(1)}.{leaf}"
    m = re.fullmatch(r"t(\d)_(adapt|new)(\d+)", sub)
    if m:
        base = f"backbone.transition{int(m.group(1)) - 1}.{m.group(3)}"
        if m.group(2) == "new":
            base += ".0"
        return f"{base}.{_CB[names[2]]}.{leaf}"
    m = re.fullmatch(r"stage(\d)_module(\d+)", sub)
    if m:
        base = f"backbone.stage{m.group(1)}.{m.group(2)}"
        b = re.fullmatch(r"branch(\d+)_block(\d+)", names[2])
        if b:
            return _block_leaf(f"{base}.branches.{b.group(1)}.{b.group(2)}",
                               names[3:], leaf)
        f = re.fullmatch(r"(up|down)(\d+)_(\d+)(?:_(\d+))?", names[3])
        base += f".fuse_layers.{f.group(2)}.{f.group(3)}"
        if f.group(1) == "down":
            base += f".{f.group(4)}"
        return f"{base}.{_CB[names[4]]}.{leaf}"
    return None


def _seg_flax_module(p, backbone=None):
    """Flax module path of a seg-head key, or of an HRNet (backbone
    'hrnet') or DDRNet ('ddrnet') backbone key, without its leaf; None
    for any other key (the inverse of `_seg_torch_name`)."""
    if p[0] in ("aux_head", "ocr_head"):
        if p[1] == "conv_seg" or p[1].endswith("_proj"):
            return (p[0], p[1])
        sub, rest = (f"conv{p[2]}", p[3]) if p[1] == "convs" else (p[1],
                                                                 p[2])
        return (p[0], sub, "Conv_0" if rest == "conv" else "BatchNorm_0")
    if p[0] != "backbone" or backbone not in ("hrnet", "ddrnet"):
        return None

    def block(base, q):
        if q[0] == "downsample":
            return base + ("downsample", _CB_INV[q[1]])
        kind, n = re.fullmatch(r"(conv|bn)(\d)", q[0]).groups()
        return base + (f"convbn{n}", kind)

    if backbone == "ddrnet":
        for flax_name, (seq, conv, bn) in _DDR_PAIRS.items():
            if p[1] == seq and p[2] in (conv, bn):
                return ("backbone", flax_name,
                        "conv" if p[2] == conv else "bn")
        if p[1] in _DDR_SEQ:
            return ("backbone", p[1], _CB_INV[p[2]])
        if p[1] == "spp":
            return ("backbone", "spp", p[2],
                    "conv" if p[3] in "23" else "bn")
        if re.fullmatch(_DDR_LAYER, p[1]) and not re.fullmatch(r"layer\d",
                                                               p[1]):
            return block(("backbone", f"{p[1]}_block{p[2]}"), p[3:])
        return None
    m = re.fullmatch(r"(conv|bn)([12])", p[1])
    if m:
        return ("backbone", f"stem{m.group(2)}", m.group(1))
    m = re.fullmatch(r"transition(\d)", p[1])
    if m:
        new = len(p) == 6
        return ("backbone", f"t{int(m.group(1)) + 1}_"
                f"{'new' if new else 'adapt'}{p[2]}", _CB_INV[p[-2]])
    m = re.fullmatch(r"stage(\d)", p[1])
    if m:
        base = ("backbone", f"stage{m.group(1)}_module{p[2]}")
        if p[3] == "branches":
            return block(base + (f"branch{p[4]}_block{p[5]}",), p[6:])
        i, j = p[4], p[5]
        name = f"up{i}_{j}" if len(p) == 8 else f"down{i}_{j}_{p[6]}"
        return base + ("fuse", name, _CB_INV[p[-2]])
    return None


# the top modules of the experiment heads (`models.experiment_heads`,
# `models.asn`), whose port names are their flax module paths
_HEAD_TOP = re.compile(r"conv0|up\d+|guide|pac|conv_depth|depth_head|"
                       r"guidance_head|fuse\d+|bn\d+|cls_\w+")
_CONV_BN = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_CONV_BN_INV = {v: k for k, v in _CONV_BN.items()}


def is_head_tree(tops) -> bool:
    """Whether the top names of a flax tree or of port keys (their first
    dotted part) are all an experiment head's: its top modules, or the
    leaves of a bare `PacConv`."""
    tops = set(tops)
    return bool(tops) and all(
        _HEAD_TOP.fullmatch(t) or t in ("kernel", "weight", "bias")
        for t in tops)


def _head_torch_name(names):
    """Port key of an experiment head's leaf path: the flax module path, a
    ConvModule's `Conv_0` as `conv`."""
    return ".".join([_CONV_BN.get(n, n) for n in names[:-1]]
                    + [_WB.get(names[-1], names[-1])])


def _head_flax_module(key):
    """Flax module path of an experiment head's port key without its leaf
    (the inverse of `_head_torch_name`)."""
    return tuple(_CONV_BN_INV.get(n, n) for n in key.split(".")[:-1])


def _torch_name(names, dpt=False, ddr=False):
    """Reference key of one flax leaf path (module names, then leaf). dpt:
    the leaf is a DPT model's (its `decode_head/conv_depth` is the head's
    last conv); ddr: a DDRNet backbone's (its `stem{n}` are the biased
    `conv1` Sequential's, not HRNet's `conv{n}`/`bn{n}`)."""
    top, leaf = names[0], _WB.get(names[-1], names[-1])
    zoo = (_seg_torch_name(names, leaf, ddr)
           or _bins_torch_name(names, leaf)
           or _zoo2_torch_name(names, leaf, dpt)
           or _zoo_torch_name(names, leaf))
    if zoo is not None:
        return zoo
    if top == "backbone":
        sub = names[1]
        if sub == "patch_embed":
            return f"backbone.patch_embed.{names[2]}.{leaf}"
        m = re.fullmatch(r"stage(\d+)_block(\d+)", sub)
        if m:
            base = f"backbone.stages.{m.group(1)}.blocks.{m.group(2)}"
            if names[2] in ("norm1", "norm2"):
                return f"{base}.{names[2]}.{leaf}"
            if names[2] == "attn":
                if names[3] == "relative_position_bias_table":
                    return f"{base}.attn.w_msa.relative_position_bias_table"
                return f"{base}.attn.w_msa.{names[3]}.{leaf}"
            if names[2] == "ffn":
                idx = {"Dense_0": "layers.0.0", "Dense_1": "layers.1"}[
                    names[3]]
                return f"{base}.ffn.{idx}.{leaf}"
        m = re.fullmatch(r"downsample(\d+)", sub)
        if m:
            return f"backbone.stages.{m.group(1)}.downsample.{names[2]}.{leaf}"
        if re.fullmatch(r"norm\d+", sub):
            return f"backbone.{sub}.{leaf}"
        if sub == "conv_stem":
            return (f"backbone.conv1.{leaf}" if names[2] == "Conv_0"
                    else f"backbone.bn1.{leaf}")
    if top == "neck":
        sub = names[1]
        for prefix, torch_base in (("lateral", "neck.lateral_convs."),
                                   ("trans_proj", "neck.trans_proj."),
                                   ("trans_fusion", "neck.trans_fusion.")):
            m = re.fullmatch(prefix + r"(\d+)", sub)
            if m:
                return _convmodule(torch_base + m.group(1), names[2:])
        if sub in ("conv_proj", "conv_fusion"):
            return _convmodule(f"neck.{sub}.0", names[2:])
        if sub == "level_embed":
            return "neck.level_embed"
        if sub == "reference_points":
            return f"neck.reference_points.{leaf}"
        if sub in ("self_attn", "cross_attn"):
            mod = "self_attn" if sub == "self_attn" else "multi_att"
            return f"neck.{mod}.{names[2]}.{leaf}"
    if top in ("pe_mask_neck", "dynamic_pe_neck"):
        conv = names[2] if names[1] == "fuse" else names[1]
        return f"{top}.{conv}.{leaf}"
    if top == "fuse":           # the stage-1 ground-mask model
        return f"fuse.{names[1]}.{leaf}"
    if top == "classifier":
        return f"classifier.{leaf}"
    if top == "decode_head":
        if names[1] == "conv0":
            return f"decode_head.conv_list.0.conv.{leaf}"
        m = re.fullmatch(r"up(\d+)", names[1])
        if m:
            return f"decode_head.conv_list.{m.group(1)}.{names[2]}.conv.{leaf}"
        if names[1] == "conv_depth":
            return f"decode_head.conv_depth.{leaf}"
    raise KeyError(f"no port parameter for {'/'.join(names)}")


def _flax_module(key, zoo=False, backbone=None):
    """Flax module path of one reference key without its leaf (the inverse
    of `_torch_name`'s module rules, per-block Swin layout). zoo: the key
    is a `ZooDepther`'s or a `SegOCRNet`'s, whose `backbone.conv1` is a
    ResNet or HRNet stem and not GEDepth's conv stem; backbone: 'hrnet' or
    'ddrnet' for those backbones' keys (`backbone_kind`)."""
    p = key.split(".")
    path = _seg_flax_module(p, backbone) or _bins_flax_module(p)
    if path is not None:
        return path
    if zoo:
        path = _zoo2_flax_module(p) or _zoo_flax_module(p)
        if path is not None:
            return path
    if p[0] == "backbone":
        if p[1] == "patch_embed":
            return ("backbone", "patch_embed", p[2])
        if p[1] == "stages" and p[3] == "blocks":
            block = ("backbone", f"stage{p[2]}_block{p[4]}")
            if p[5] in ("norm1", "norm2"):
                return block + (p[5],)
            if p[5] == "attn":
                return block + ("attn",) + tuple(p[7:-1])
            if p[5] == "ffn":
                return block + ("ffn", "Dense_0" if p[7] == "0" else "Dense_1")
        if p[1] == "stages" and p[3] == "downsample":
            return ("backbone", f"downsample{p[2]}", p[4])
        if re.fullmatch(r"norm\d+", p[1]):
            return ("backbone", p[1])
        if p[1] == "conv1":
            return ("backbone", "conv_stem", "Conv_0")
        if p[1] == "bn1":
            return ("backbone", "conv_stem", "BatchNorm_0")
    if p[0] == "neck":
        conv_bn = {"conv": "Conv_0", "bn": "BatchNorm_0"}
        for torch_base, flax_base in (("lateral_convs", "lateral"),
                                      ("trans_proj", "trans_proj"),
                                      ("trans_fusion", "trans_fusion")):
            if p[1] == torch_base:
                return ("neck", flax_base + p[2], conv_bn[p[3]])
        if p[1] in ("conv_proj", "conv_fusion"):
            return ("neck", p[1], conv_bn[p[3]])
        if p[1] == "reference_points":
            return ("neck", p[1])
        if p[1] in ("self_attn", "multi_att"):
            return ("neck", "self_attn" if p[1] == "self_attn"
                    else "cross_attn", p[2])
    if p[0] in ("pe_mask_neck", "dynamic_pe_neck"):
        return ((p[0], p[1]) if p[1] == "convfinal"
                else (p[0], "fuse", p[1]))
    if p[0] == "fuse":
        return ("fuse", p[1])
    if p[0] == "classifier":
        return ("classifier",)
    if p[0] == "decode_head":
        if p[1] == "conv_list":
            if p[2] == "0":
                return ("decode_head", "conv0", "Conv_0")
            return ("decode_head", f"up{p[2]}", p[3], "Conv_0")
        if p[1] == "conv_depth":
            return ("decode_head", "conv_depth")
    raise KeyError(f"no flax path for {key}")


def flax_path(key: str, ndim: int, zoo: bool = False, backbone=None,
              head: bool = False):
    """(collection, flax path) of one port state_dict entry of `ndim`
    dimensions, the inverse of `_torch_name`; None for
    `num_batches_tracked`, which flax does not keep. A `weight` is a
    `kernel` when it has two dimensions or more, else a norm's `scale`.
    zoo, backbone: see `_flax_module`; head: the key is an experiment
    head's (`is_head_tree`)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return None
    if head:
        module = _head_flax_module(key)
    elif key == "neck.level_embed":
        return "params", ("neck", "level_embed")
    elif key in _BINS_TABLES_INV:
        return "params", ("decode_head", _BINS_TABLES_INV[key])
    elif leaf == "relative_position_bias_table":
        return "params", _flax_module(key) + (leaf,)
    else:
        module = _flax_module(key, zoo, backbone)
    stats = {"running_mean": "mean", "running_var": "var"}
    if leaf in stats:
        return "batch_stats", module + (stats[leaf],)
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return "params", module + (leaf,)


# backbone keys only a zoo model has: ResNet, ViT, EfficientNet, timm's
_ZOO_BACKBONES = ("backbone.layer", "backbone.cls_token", "backbone.stem.",
                  "backbone.original_model.")


def is_zoo_state_dict(state_dict: Mapping) -> bool:
    """Whether a state_dict is a `ZooDepther`'s or a `SegOCRNet`'s (by its
    backbone)."""
    return any(k.startswith(_ZOO_BACKBONES) for k in state_dict)


def backbone_kind(keys):
    """'hrnet' or 'ddrnet' when the keys hold those backbones' structural
    keys (the JAX converter's detection: `.fuse_layers.` or
    `backbone.transition`; `backbone.spp.scale` or
    `backbone.compression3_1.`), else None."""
    keys = list(keys)
    if any(k.startswith(("backbone.spp.scale", "backbone.compression3_1."))
           for k in keys):
        return "ddrnet"
    if any(".fuse_layers." in k or k.startswith("backbone.transition")
           for k in keys):
        return "hrnet"
    return None


def _put(tree, names, arr):
    node = tree
    for n in names[:-1]:
        node = node.setdefault(n, {})
    node[names[-1]] = np.ascontiguousarray(arr)


def flax_variables_from_state_dict(state_dict: Mapping):
    """(params, batch_stats) of the JAX GEDepth, nested dicts of f32 numpy
    arrays in the per-block Swin layout, for the port's `state_dict`: conv
    kernels OIHW -> HWIO, dense kernels transposed, `num_batches_tracked`
    dropped; packed attention weights and the DPT's transposed convs split
    as `_split_torch` says. The inverse of `state_dict_from_flax`."""
    trees = {"params": {}, "batch_stats": {}}
    zoo = is_zoo_state_dict(state_dict)
    kind = backbone_kind(state_dict)
    head = is_head_tree(k.split(".", 1)[0] for k in state_dict)
    for key, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        split = _split_torch(key, arr)
        if split is not None:
            for names, part in split:
                _put(trees["params"], names, part)
            continue
        where = flax_path(key, t.dim(), zoo, kind, head)
        if where is None:
            continue
        collection, names = where
        if names[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        _put(trees[collection], names, arr)
    return trees["params"], trees["batch_stats"]


def state_dict_from_flax(params: Mapping, batch_stats: Mapping = None):
    """The port's state_dict (f32 CPU tensors) for JAX GEDepth variables."""
    params = dict(params)
    if "backbone" in params:
        params["backbone"] = unstack_swin_params(params["backbone"])
    dpt = "reassemble0" in params.get("decode_head", {})
    ddr = any("spp" in tree.get("backbone", {})
              for tree in (params, batch_stats or {}))
    head = is_head_tree(list(params) + list(batch_stats or {}))
    fused, leaves = _fuse_flax(list(_flatten(params)))
    sd = {k: torch.from_numpy(np.array(v, np.float32, order="C"))
          for k, v in fused.items()}
    if batch_stats:
        leaves += list(_flatten(batch_stats))
    for names, arr in leaves:
        key = _head_torch_name(names) if head else _torch_name(names, dpt,
                                                               ddr)
        if names[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


ADABINS_CONV_OUT = "decode_head.conv_out.0.weight"


def load_flax_variables(model, params: Mapping, batch_stats: Mapping = None):
    """Load JAX GEDepth variables into the port's `model`, strictly. A tree
    of another sampling mode (with or without `neck/reference_points`) or
    another PE variant (PE necks, patch-embed channels) is refused. An
    AdaBins `conv_out` that the JAX package built at an input with Q <
    `channels` range queries takes the first Q of the port's inputs, the
    others zero (`models.adabins`)."""
    sd = state_dict_from_flax(params, batch_stats)
    want = model.state_dict()
    w = sd.get(ADABINS_CONV_OUT)
    if (w is not None and ADABINS_CONV_OUT in want
            and w.shape[1] < want[ADABINS_CONV_OUT].shape[1]):
        sd[ADABINS_CONV_OUT] = torch.cat([w, w.new_zeros(
            (w.shape[0], want[ADABINS_CONV_OUT].shape[1] - w.shape[1])
            + w.shape[2:])], dim=1)
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    shapes = [k for k in sd if k in want and sd[k].shape != want[k].shape]
    if missing or extra or shapes:
        def about(prefixes):
            return any(k.startswith(prefixes) for k in missing + extra + shapes)
        why = []
        if about(("neck.reference_points",)):
            why.append("the neck's sampling mode (only 'windowed' has no "
                       "reference_points layer)")
        if about(("pe_mask_neck", "dynamic_pe_neck",
                  "backbone.patch_embed.projection")):
            why.append("the PE variant")
        if about(("backbone.layer", "backbone.patch_embed",
                  "decode_head.upconv", "decode_head.conv_list")):
            why.append("the architecture (arch, backbone_variant)")
        raise ValueError(
            "the JAX tree does not fit this model: it differs in "
            f"{' and '.join(why) or 'its layers'}; missing {missing[:4]}, "
            f"unexpected {extra[:4]}, other shapes {shapes[:4]}")
    model.load_state_dict(sd, strict=True)
    return model
