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


def _torch_name(names):
    """Reference key of one flax leaf path (module names, then leaf)."""
    top, leaf = names[0], _WB.get(names[-1], names[-1])
    zoo = _zoo_torch_name(names, leaf)
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


def _flax_module(key, zoo=False):
    """Flax module path of one reference key without its leaf (the inverse
    of `_torch_name`'s module rules, per-block Swin layout). zoo: the key
    is a `ZooDepther`'s, whose `backbone.conv1` is a ResNet stem and not
    GEDepth's conv stem."""
    p = key.split(".")
    if zoo:
        path = _zoo_flax_module(p)
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


def flax_path(key: str, ndim: int, zoo: bool = False):
    """(collection, flax path) of one port state_dict entry of `ndim`
    dimensions, the inverse of `_torch_name`; None for
    `num_batches_tracked`, which flax does not keep. A `weight` is a
    `kernel` when it has two dimensions or more, else a norm's `scale`.
    zoo: the entry is a `ZooDepther`'s (see `_flax_module`)."""
    leaf = key.rsplit(".", 1)[1]
    if leaf == "num_batches_tracked":
        return None
    if key == "neck.level_embed":
        return "params", ("neck", "level_embed")
    if leaf == "relative_position_bias_table":
        return "params", _flax_module(key) + (leaf,)
    stats = {"running_mean": "mean", "running_var": "var"}
    if leaf in stats:
        return "batch_stats", _flax_module(key, zoo) + (stats[leaf],)
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return "params", _flax_module(key, zoo) + (leaf,)


def is_zoo_state_dict(state_dict: Mapping) -> bool:
    """Whether a state_dict is a `ZooDepther`'s (a ResNet backbone)."""
    return any(k.startswith("backbone.layer") for k in state_dict)


def flax_variables_from_state_dict(state_dict: Mapping):
    """(params, batch_stats) of the JAX GEDepth, nested dicts of f32 numpy
    arrays in the per-block Swin layout, for the port's `state_dict`: conv
    kernels OIHW -> HWIO, dense kernels transposed, `num_batches_tracked`
    dropped. The inverse of `state_dict_from_flax`."""
    trees = {"params": {}, "batch_stats": {}}
    zoo = is_zoo_state_dict(state_dict)
    for key, t in state_dict.items():
        where = flax_path(key, t.dim(), zoo)
        if where is None:
            continue
        collection, names = where
        arr = t.detach().float().cpu().numpy()
        if names[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = trees[collection]
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = np.ascontiguousarray(arr)
    return trees["params"], trees["batch_stats"]


def state_dict_from_flax(params: Mapping, batch_stats: Mapping = None):
    """The port's state_dict (f32 CPU tensors) for JAX GEDepth variables."""
    params = dict(params)
    if "backbone" in params:
        params["backbone"] = unstack_swin_params(params["backbone"])
    sd = {}
    leaves = list(_flatten(params))
    if batch_stats:
        leaves += list(_flatten(batch_stats))
    for names, arr in leaves:
        key = _torch_name(names)
        if names[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return sd


def load_flax_variables(model, params: Mapping, batch_stats: Mapping = None):
    """Load JAX GEDepth variables into the port's `model`, strictly. A tree
    of another sampling mode (with or without `neck/reference_points`) or
    another PE variant (PE necks, patch-embed channels) is refused."""
    sd = state_dict_from_flax(params, batch_stats)
    want = model.state_dict()
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
