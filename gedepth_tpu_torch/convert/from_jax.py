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

The trees differ with the model: only the windowed neck lacks
`neck/reference_points` (the cross-attention's learned reference points,
`neck.reference_points.{weight,bias}` in the reference), a model without
ground embedding has no `pe_mask_neck` and a 3-channel patch embed, and only
the adaptive one has `dynamic_pe_neck`. `load_flax_variables` loads a tree
into a model strictly and says which of the two, sampling mode or PE
variant, does not match when the keys differ.
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


def _torch_name(names):
    """Reference key of one flax leaf path (module names, then leaf)."""
    top, leaf = names[0], _WB.get(names[-1], names[-1])
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
    if top == "decode_head":
        if names[1] == "conv0":
            return f"decode_head.conv_list.0.conv.{leaf}"
        m = re.fullmatch(r"up(\d+)", names[1])
        if m:
            return f"decode_head.conv_list.{m.group(1)}.{names[2]}.conv.{leaf}"
        if names[1] == "conv_depth":
            return f"decode_head.conv_depth.{leaf}"
    raise KeyError(f"no port parameter for {'/'.join(names)}")


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
        raise ValueError(
            "the JAX tree does not fit this model: it differs in "
            f"{' and '.join(why) or 'its layers'}; missing {missing[:4]}, "
            f"unexpected {extra[:4]}, other shapes {shapes[:4]}")
    model.load_state_dict(sd, strict=True)
    return model
