"""An official ViT checkpoint (timm, AugReg or DeiT naming) to the port's
`models.vit.VisionTransformer` (the port of
`gedepth_tpu.convert.vit_official`, the reference's
tools/model_converters/vit2depth.py role).

  cls_token, pos_embed            -> cls_token (1, 1, C), pos_embed (1, L, C)
  patch_embed.proj.{weight,bias}  -> patch_embed.{weight,bias}
  blocks.{i}.norm{1,2}            -> blocks.{i}.ln{1,2}
  blocks.{i}.attn.qkv, .attn.proj -> the same (the port packs q, k and v
                                     as timm does)
  blocks.{i}.mlp.fc{1,2}          -> blocks.{i}.ffn.layers.{0.0,1}

The classifier (`norm`, `head`, `fc_norm`) is left out: the DPT reads the
blocks' tokens. Prefix the keys with `backbone.` for a `ZooDepther`.
"""
from __future__ import annotations

from typing import Dict

import torch

_BLOCK_RENAMES = {"norm1": "ln1", "norm2": "ln2", "attn.qkv": "attn.qkv",
                  "attn.proj": "attn.proj", "mlp.fc1": "ffn.layers.0.0",
                  "mlp.fc2": "ffn.layers.1"}


def convert_vit_official(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The state dict of the port's VisionTransformer for a timm-named
    ViT's `sd`, every block of it. A key it needs and does not find raises
    KeyError."""
    c = sd["cls_token"].shape[-1]
    num_blocks = 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("blocks."))
    out = {"cls_token": sd["cls_token"].reshape(1, 1, c),
           "pos_embed": sd["pos_embed"].reshape(1, -1, c),
           "patch_embed.weight": sd["patch_embed.proj.weight"],
           "patch_embed.bias": sd["patch_embed.proj.bias"]}
    for i in range(num_blocks):
        for theirs, ours in _BLOCK_RENAMES.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{leaf}"] = \
                    sd[f"blocks.{i}.{theirs}.{leaf}"]
    return {k: v.contiguous() for k, v in out.items()}
