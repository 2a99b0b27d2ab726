"""Load a reference GEDepth `.pth` (or an official Swin ImageNet checkpoint)
into the port's model (the GEDepth part of
`gedepth_tpu.convert.torch_to_jax`).

The port's parameters carry the reference's names, so a reference state
dict needs no renaming, only what the JAX converter does around its
renames:

  * `load_torch_checkpoint`: unwrap `state_dict` or `model`, strip the
    `module.` prefix of a DataParallel save;
  * `swin_official_to_gedepth`: official Swin keys to the reference
    backbone's, with the PatchMerging channel reorder;
  * `reference_key_rule`: which keys are GEDepth's (kept), which the model
    recomputes or does not keep (dropped: `relative_position_index`,
    `num_batches_tracked`) and which are neither (reported as unmapped);
  * `pad_patch_embed_for_pe`: a 3-channel patch embed zero-padded to the 4
    channels of a model with ground embedding;
  * `resize_swin_pos_tables`: relative-position tables of another window
    size resized bicubically (`F.interpolate`, the reference's own call);
  * `convert_checkpoint_file`: all of it into a model, whose missing keys
    keep their seeded initialisation, with a report of the unmapped and
    missing keys.

The zoo's BTS decode head maps as the JAX converter maps it
(torch_to_jax.py's bts_head.py rules: `upconv{n}.conv`, `bn{n}`, `bn4_2`,
`conv{n}.0`, `daspp_{d}.atrous_conv.{first_bn, aconv_sequence.{1,2,4}}`,
`daspp_conv.0`, `reduc*.reduc.{inter_*.0, plane_params, final.0}`, and
`conv_depth`); DenseDepth's head has GEDepth's keys; the DPT head
(`reassemble_blocks.*`, `convs`, `fusion_blocks`, `project`,
`conv_depth.head`) and the AdaBins head (`decode_final_conv`,
`adaptive_bins_layer.*`, `conv_out.0`, and DenseDepth's `conv_list`) map as
the JAX converter's dpt_head.py and adabins_head.py rules map them. Of the
backbones, the JAX converter maps timm's EfficientNet under
`backbone.original_model.` (the AdaBins reference's tf_efficientnet_b5_ap),
which the port's `TimmEfficientNet` carries under the same names. It has no
rule for a ResNet, a ViT or the compact EfficientNet: `backbone.conv1`,
`bn1` and `patch_embed.projection` go to GEDepth's stems, which a zoo
model lacks, and the rest stays unmapped. So a zoo model other than a tf_
AdaBins takes its decode head from a reference file and keeps its seeded
backbone, as in the JAX package, although the ResNet carries the
reference's names: such backbone keys are reported as unused.

BinsFormer's head (binsformer_head.py and transformer.py names:
`skip_proj`, `lateral_convs` and `output_convs` ConvModules, the level
embeds and queries, `transformer_encoder.encoder.layers.N.{attentions.0,
ffns.0, norms}`, `transformer_decoder.layers.N.{attentions.{0,1}.attn,
ffns.0, norms}`, `decoder_norm`, `bins_embed`, `mask_embed`,
`class_embed`) keeps its keys: the JAX converter splits each decoder
attention's packed `in_proj` into flax's query, key and value kernels of 8
heads, and the port keeps torch's packing. The encoder's
`transformer_encoder.reference_points` layer, which its encoder-only
forward never reads, is dropped, as the JAX converter drops it. Its Swin
backbone takes GEDepth's backbone keys. `binsformer_release_remap` is the
released checkpoints' key fix (the reference's
tools/model_converters/binsformer.py).

An HRNet or DDRNet backbone (mmcv's HRNet names, the reference's
ddrnet.py names) is detected as the JAX converter detects it, by its
structural keys (`from_jax.backbone_kind`); then its backbone keys follow
that converter's HRNet or DDRNet rules (`hrnet_key_rule`,
`ddrnet_key_rule`): the keys they map load as they are into the seg
model's HRNet (or a `DualResNet`), `num_batches_tracked` is dropped, and a
key they do not map (a deeper transition chain, a diagonal fuse layer, a
conv bias) is reported as unmapped. The JAX converter has no rule for the
seg model's decode heads: they keep their seeded initialisation.

A reference transposed conv of the DPT reassemble blocks has one bias a
channel; the port's (and the JAX package's) has one a channel and
sub-pixel, so the file's is spread over the sub-pixels (`np.tile` in the
JAX converter).
"""
from __future__ import annotations

import re
from typing import Dict

import torch
import torch.nn.functional as F

from gedepth_tpu_torch.convert.from_jax import backbone_kind

_BLOCK_LEAVES = {
    "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
    "attn.w_msa.relative_position_bias_table",
    "attn.w_msa.qkv.weight", "attn.w_msa.qkv.bias",
    "attn.w_msa.proj.weight", "attn.w_msa.proj.bias",
    "ffn.layers.0.0.weight", "ffn.layers.0.0.bias",
    "ffn.layers.1.weight", "ffn.layers.1.bias"}
_CONVMODULE_LEAVES = {"conv.weight", "conv.bias", "bn.weight", "bn.bias",
                      "bn.running_mean", "bn.running_var"}
_WB = r"(weight|bias)"
_BN = r"(weight|bias|running_mean|running_var)"
# GEDepth's reference keys outside the Swin blocks and the ConvModules
# (gedepth_tpu/convert/torch_to_jax.py `_map_torch_key`)
_KEPT = [re.compile(p + "$") for p in (
    r"backbone\.absolute_pos_embed",
    r"backbone\.patch_embed\.(projection|norm)\." + _WB,
    r"backbone\.stages\.\d+\.downsample\.(norm|reduction)\." + _WB,
    r"backbone\.norm\d\." + _WB,
    r"backbone\.conv1\.weight",
    r"backbone\.bn1\." + _BN,
    r"neck\.reference_points\." + _WB,
    r"neck\.level_embed",
    r"neck\.(self_attn|multi_att)\.(sampling_offsets|attention_weights|"
    r"value_proj|output_proj)\." + _WB,
    r"(pe_mask_neck|dynamic_pe_neck)\.(conv\d|convfinal)\." + _WB,
    r"decode_head\.conv_list\.0\.conv\." + _WB,
    r"decode_head\.conv_list\.\d+\.(convA|convB)\.conv\." + _WB,
    r"decode_head\.conv_depth\." + _WB,
    # the BTS head (bts_head.py names, torch_to_jax.py's BTS rules)
    r"decode_head\.upconv\d\.conv\.weight",
    r"decode_head\.bn\d(_2)?\." + _BN,
    r"decode_head\.(conv\d|daspp_conv)\.0\.weight",
    r"decode_head\.daspp_\d+\.atrous_conv\.first_bn\." + _BN,
    r"decode_head\.daspp_\d+\.atrous_conv\.aconv_sequence\.[14]\.weight",
    r"decode_head\.daspp_\d+\.atrous_conv\.aconv_sequence\.2\." + _BN,
    r"decode_head\.reduc\d+x\d+\.reduc\.(inter_\d+_\d+\.0|plane_params|"
    r"final\.0)\.weight",
    # timm's EfficientNet (torch_to_jax.py `_map_timm_effnet_key`)
    r"backbone\.original_model\.(conv_stem|conv_head)\.weight",
    r"backbone\.original_model\.bn1\." + _BN,
    r"backbone\.original_model\.blocks\.\d+\.\d+\.(conv_pw|conv_dw|"
    r"conv_pwl)\.weight",
    r"backbone\.original_model\.blocks\.\d+\.\d+\.bn\d\." + _BN,
    r"backbone\.original_model\.blocks\.\d+\.\d+\.se\.(conv_reduce|"
    r"conv_expand)\." + _WB,
    # the AdaBins head (adabins_head.py names)
    r"decode_head\.(decode_final_conv|conv_out\.0)\." + _WB,
    r"decode_head\.adaptive_bins_layer\.(conv3x3|regressor\.[024])\." + _WB,
    r"decode_head\.adaptive_bins_layer\.patch_transformer\."
    r"(positional_encodings|embedding_convPxP\.(weight|bias))",
    r"decode_head\.adaptive_bins_layer\.patch_transformer\."
    r"transformer_encoder\.layers\.\d+\.(self_attn\.in_proj_(weight|bias)|"
    r"self_attn\.out_proj\.(weight|bias)|(linear|norm)\d\.(weight|bias))",
    # the DPT head (dpt_head.py names)
    r"decode_head\.reassemble_blocks\.(readout_projects\.\d\.0|"
    r"projects\.\d\.conv|resize_layers\.[013])\." + _WB,
    r"decode_head\.convs\.\d\.conv\.weight",
    r"decode_head\.fusion_blocks\.\d\.project\.conv\." + _WB,
    r"decode_head\.fusion_blocks\.\d\.res_conv_unit[12]\.conv[12]\.conv\."
    r"weight",
    r"decode_head\.project\.conv\." + _WB,
    r"decode_head\.conv_depth\.head\.[024]\." + _WB,
    # the BinsFormer head (binsformer_head.py and transformer.py names)
    r"decode_head\.(level_embed|query_feat|query_embed)\.weight",
    r"decode_head\.transformer_encoder\.level_embeds",
    r"decode_head\.transformer_encoder\.encoder\.layers\.\d+\.attentions"
    r"\.0\.(sampling_offsets|attention_weights|value_proj|output_proj)\."
    + _WB,
    r"decode_head\.transformer_(encoder\.encoder|decoder)\.layers\.\d+\."
    r"(ffns\.0\.layers\.(0\.0|1)|norms\.\d)\." + _WB,
    r"decode_head\.transformer_decoder\.layers\.\d+\.attentions\.[01]\."
    r"attn\.(in_proj_(weight|bias)|out_proj\.(weight|bias))",
    r"decode_head\.transformer_decoder\.(decoder_norm|bins_embed|"
    r"(mask_embed|class_embed)\.layers\.\d)\." + _WB)]
# keys the JAX converter drops: the BinsFormer encoder's unused learned
# reference points
_DROPPED = re.compile(
    r"decode_head\.transformer_encoder\.reference_points\." + _WB + "$")
# timm keys past the deepest endpoint, which the JAX converter drops
_TIMM_DROPPED = re.compile(
    r"backbone\.original_model\.((bn2|classifier|global_pool)\..*|"
    r"(bn1|blocks\.\d+\.\d+\.bn\d)\.num_batches_tracked)$")
# BatchNorms whose `num_batches_tracked` the converter drops
_BN_TRACKED = re.compile(
    r"(backbone\.bn1|decode_head\.bn\d(_2)?|decode_head\.daspp_\d+\."
    r"atrous_conv\.(first_bn|aconv_sequence\.2))\.num_batches_tracked$")
_CONVMODULE = re.compile(r"(neck\.(lateral_convs\.\d+|trans_proj\.\d+|"
                         r"trans_fusion\.\d+|conv_proj\.0|conv_fusion\.0)|"
                         r"decode_head\.(skip_proj|lateral_convs|"
                         r"output_convs)\.\d+)\.(.*)$")
_BLOCK = re.compile(r"backbone\.stages\.\d+\.blocks\.\d+\.(.*)$")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a `.pth` on the CPU, by key: the `state_dict` or
    `model` entry of a training checkpoint, `module.` prefixes stripped.
    Loaded with `weights_only=True`: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in ckpt.items() if torch.is_tensor(v)}


def swin_official_to_gedepth(sd: Dict[str, torch.Tensor]):
    """Official Swin checkpoint keys -> reference backbone keys (without the
    `backbone.` prefix): layers -> stages, mlp -> ffn, attn -> attn.w_msa,
    patch_embed.proj -> projection, the classifier head dropped, and the
    PatchMerging reduction and norm reordered from the official position-
    major concatenation [(0,0), (1,0), (0,1), (1,1)] to the channel-major
    raster order of torch's Unfold (the reference's
    `correct_unfold_reduction_order`)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("head."):
            continue
        nk = (k.replace("layers.", "stages.")
              .replace("patch_embed.proj", "patch_embed.projection")
              .replace("mlp.fc1", "ffn.layers.0.0")
              .replace("mlp.fc2", "ffn.layers.1"))
        m = re.match(r"(.*)\.attn\.(qkv|proj|relative_position_bias_table|"
                     r"relative_position_index)(.*)", nk)
        if m:
            nk = f"{m.group(1)}.attn.w_msa.{m.group(2)}{m.group(3)}"
        if "downsample.reduction.weight" in nk:
            o, i = v.shape
            v = v.reshape(o, 4, i // 4)[:, [0, 2, 1, 3], :]
            v = v.transpose(1, 2).reshape(o, i)
        elif "downsample.norm." in nk:
            i = v.shape[0]
            v = v.reshape(4, i // 4)[[0, 2, 1, 3], :]
            v = v.transpose(0, 1).reshape(i)
        out[nk] = v.contiguous()
    return out


def _conv_bn_leaf(kind, leaf):
    """The rule of a conv's or a BatchNorm's leaf in the JAX converter's
    `_hrnet_cbn`: a conv keeps its weight only, a BatchNorm its affine
    parameters and statistics and drops `num_batches_tracked`."""
    if kind == "conv":
        return True if leaf == "weight" else None
    if leaf == "num_batches_tracked":
        return False
    return True if leaf in ("weight", "bias", "running_mean",
                            "running_var") else None


def _block_rule(rest):
    """A residual block's `conv{n}.weight`, `bn{n}.*`, `downsample.{0,1}.*`."""
    m = re.fullmatch(r"(conv|bn)\d\.(\w+)", rest)
    if m:
        return _conv_bn_leaf(m.group(1), m.group(2))
    m = re.fullmatch(r"downsample\.([01])\.(\w+)", rest)
    if m:
        return _conv_bn_leaf("conv" if m.group(1) == "0" else "bn",
                             m.group(2))
    return None


def hrnet_key_rule(key: str):
    """`reference_key_rule` for an mmcv HRNet backbone key
    (`gedepth_tpu.convert.torch_to_jax._map_hrnet_key`): the stems
    `conv{1,2}`/`bn{1,2}`, `layer1` and branch blocks, the transitions (a
    new branch's first step only) and the fuse layers (up above the
    diagonal, down chains below it)."""
    k = key[len("backbone."):]
    m = re.fullmatch(r"(conv|bn)[12]\.(\w+)", k)
    if m:
        return _conv_bn_leaf(m.group(1), m.group(2))
    m = re.fullmatch(r"(?:layer1\.\d+|stage\d\.\d+\.branches\.\d+\.\d+)"
                     r"\.(.*)", k)
    if m:
        return _block_rule(m.group(1))
    m = re.fullmatch(r"transition\d\.\d+\.(?:(\d+)\.)?([01])\.(\w+)", k)
    if m:
        if m.group(1) not in (None, "0"):
            return None
        return _conv_bn_leaf("conv" if m.group(2) == "0" else "bn",
                             m.group(3))
    m = re.fullmatch(r"stage\d\.\d+\.fuse_layers\.(\d+)\.(\d+)\."
                     r"(?:(\d+)\.)?([01])\.(\w+)", k)
    if m:
        i, j = int(m.group(1)), int(m.group(2))
        if (j <= i) if m.group(3) is None else (j >= i):
            return None
        return _conv_bn_leaf("conv" if m.group(4) == "0" else "bn",
                             m.group(5))
    return None


def ddrnet_key_rule(key: str):
    """`reference_key_rule` for a DDRNet backbone key
    (`gedepth_tpu.convert.torch_to_jax._map_ddrnet_key`): the biased stem
    Sequential `conv1`, the layers' blocks, the fusion Sequentials,
    `down4` and DAPPM's pre-activation Sequentials."""
    k = key[len("backbone."):]
    m = re.fullmatch(r"conv1\.([0134])\.(\w+)", k)
    if m:
        if m.group(1) in "03":
            return True if m.group(2) in ("weight", "bias") else None
        return _conv_bn_leaf("bn", m.group(2))
    m = re.fullmatch(r"layer\d(?:_\d)?_?\.\d+\.(.*)", k)
    if m:
        return _block_rule(m.group(1))
    m = re.fullmatch(r"(?:compression3_1|compression3_2|compression4|"
                     r"down3_1|down3_2|out_conv)\.([01])\.(\w+)", k)
    if m:
        return _conv_bn_leaf("conv" if m.group(1) == "0" else "bn",
                             m.group(2))
    m = re.fullmatch(r"down4\.([0134])\.(\w+)", k)
    if m:
        return _conv_bn_leaf("conv" if m.group(1) in "03" else "bn",
                             m.group(2))
    m = re.fullmatch(r"spp\.(?:scale\d|process\d|compression|shortcut)\."
                     r"(\d)\.(\w+)", k)
    if m:
        return _conv_bn_leaf("conv" if m.group(1) in "23" else "bn",
                             m.group(2))
    return None


def reference_key_rule(key: str, backbone=None):
    """True for a GEDepth reference key the port keeps, False for one it
    drops (`attn.w_msa.relative_position_index`, computed by the model;
    BatchNorm's `num_batches_tracked`), None for a key no rule maps.
    backbone: 'hrnet' or 'ddrnet' when the state dict holds that backbone
    (`from_jax.backbone_kind`); its `backbone.` keys then follow
    `hrnet_key_rule` or `ddrnet_key_rule`."""
    if backbone is not None and key.startswith("backbone."):
        return (hrnet_key_rule if backbone == "hrnet"
                else ddrnet_key_rule)(key)
    m = _BLOCK.match(key)
    if m:
        if m.group(1) in _BLOCK_LEAVES:
            return True
        return False if m.group(1) == "attn.w_msa.relative_position_index" \
            else None
    m = _CONVMODULE.match(key)
    if m:
        leaf = m.group(m.lastindex)
        if leaf in _CONVMODULE_LEAVES:
            return True
        return False if leaf == "bn.num_batches_tracked" else None
    if (_BN_TRACKED.match(key) or _TIMM_DROPPED.match(key)
            or _DROPPED.match(key)):
        return False
    return True if any(p.match(key) for p in _KEPT) else None


def pad_patch_embed_for_pe(sd: Dict[str, torch.Tensor]):
    """Zero-pad a 3-channel patch-embed conv to 4 input channels, in place
    (the reference's depthformer_swin.py:1113-1123); returns `sd`."""
    key = "backbone.patch_embed.projection.weight"
    if key in sd and sd[key].shape[1] == 3:
        w = sd[key]
        sd[key] = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
    return sd


def resize_swin_pos_tables(sd: Dict[str, torch.Tensor],
                           model_sd: Dict[str, torch.Tensor]):
    """Resize, in place, every `relative_position_bias_table` (L1, nH) whose
    L1 differs from the model's L2 through its (2w-1, 2w-1) grid with
    `F.interpolate(mode="bicubic", align_corners=False)` in float64; a
    table with another head count or a non-square grid is left alone (the
    reference warns and skips). Returns `sd`."""
    for k, v in sd.items():
        want = model_sd.get(k)
        if (not k.endswith("relative_position_bias_table") or want is None
                or v.shape == want.shape or v.shape[-1] != want.shape[-1]):
            continue
        s1, s2 = round(v.shape[0] ** 0.5), round(want.shape[0] ** 0.5)
        if s1 * s1 != v.shape[0] or s2 * s2 != want.shape[0]:
            continue
        grid = v.double().T.reshape(1, -1, s1, s1)         # (1, nH, S, S)
        grid = F.interpolate(grid, size=(s2, s2), mode="bicubic",
                             align_corners=False)
        sd[k] = grid.reshape(-1, s2 * s2).T.to(v.dtype).contiguous()
    return sd


def spread_deconv_bias(sd: Dict[str, torch.Tensor],
                       model_sd: Dict[str, torch.Tensor]):
    """In place: a DPT transposed conv's bias of one value a channel (F,)
    repeated over the (F, k, k) sub-pixels of the model's. Returns `sd`."""
    for k, v in sd.items():
        want = model_sd.get(k)
        if (re.fullmatch(r"decode_head\.reassemble_blocks\.resize_layers\."
                         r"[01]\.bias", k) and want is not None
                and v.dim() == 1 and want.dim() == 3):
            sd[k] = v[:, None, None].expand(want.shape).contiguous()
    return sd


def binsformer_release_remap(sd: Dict[str, torch.Tensor]):
    """The released BinsFormer checkpoints nest the pixel decoder one level
    deeper than the model: `decode_head.transformer_decoder.decoder.X` ->
    `decode_head.transformer_decoder.X` (the reference's
    tools/model_converters/binsformer.py)."""
    pre = "decode_head.transformer_decoder.decoder."
    tgt = "decode_head.transformer_decoder."
    return {(tgt + k[len(pre):]) if k.startswith(pre) else k: v
            for k, v in sd.items()}


def simipu_backbone_extract(sd: Dict[str, torch.Tensor]):
    """A SimIPU pretraining checkpoint's backbone: the keys that hold
    `img_backbone`, without their first 4 characters (`img_backbone.X` ->
    `backbone.X`), as the reference's tools/model_converters/SimIPU.py
    keeps them; every other key is dropped."""
    return {k[4:]: v for k, v in sd.items() if "img_backbone" in k}


def convert_state_dict(sd: Dict[str, torch.Tensor]):
    """(kept entries, unmapped keys) of a reference state dict, by
    `reference_key_rule` (an HRNet's or DDRNet's backbone by its rule)."""
    kind = backbone_kind(sd)
    rules = {k: reference_key_rule(k, kind) for k in sd}
    return ({k: v for k, v in sd.items() if rules[k]},
            [k for k, r in rules.items() if r is None])


def convert_checkpoint_file(pth_path: str, model, official_swin=False,
                            binsformer_release=False, simipu=False):
    """Load a reference `.pth` into `model` (the port's `GEDepth`, on any
    device); returns (model, report).

    official_swin: the file is an official Swin ImageNet checkpoint; its
    backbone goes in and the rest of the model keeps its weights. A model
    with ground embedding takes a 3-channel patch embed zero-padded; Swin
    tables of another window size are resized. Keys of the file that the
    model lacks (the windowed neck's `reference_points`, say) are ignored,
    as the JAX converter ignores them; model keys the file lacks keep their
    values. report: `unmapped_torch_keys` (keys no rule maps),
    `missing_params` and `missing_stats` (model parameters and BatchNorm
    running statistics the file did not give) and, for a zoo or seg
    model, `unused_torch_keys` (backbone keys the JAX converter sends to
    GEDepth's stems, which such a model lacks: `backbone.conv1`,
    `backbone.bn1`, `backbone.patch_embed.projection`; none for BinsFormer,
    whose Swin takes them, or for a file of an HRNet or DDRNet, whose
    rules keep them). binsformer_release: apply
    `binsformer_release_remap` first; simipu: then keep the backbone of a
    SimIPU pretraining file (`simipu_backbone_extract`), before
    official_swin renames it."""
    sd = load_torch_checkpoint(pth_path)
    if binsformer_release:
        sd = binsformer_release_remap(sd)
    if simipu:
        sd = simipu_backbone_extract(sd)
    if official_swin:
        sd = {f"backbone.{k}": v
              for k, v in swin_official_to_gedepth(sd).items()}
    kept = backbone_kind(sd) is not None
    sd, unmapped = convert_state_dict(sd)
    zoo = getattr(model, "arch", "gedepth") != "gedepth"
    if zoo:
        kept = kept or getattr(model, "arch", "") == "binsformer"
        unused = [] if kept else sorted(
            k for k in sd if k.startswith("backbone.") and
            not k.startswith("backbone.original_model."))
        sd = {k: v for k, v in sd.items() if k not in unused}
    if model.pe_variant != "none":
        pad_patch_embed_for_pe(sd)
    merged = model.state_dict()
    spread_deconv_bias(sd, merged)
    resize_swin_pos_tables(sd, merged)
    params = dict(model.named_parameters())
    missing_p, missing_s = [], []
    for k, want in merged.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k not in sd:
            (missing_p if k in params else missing_s).append(k)
        elif sd[k].shape != want.shape:
            raise ValueError(f"{pth_path}: {k} has shape "
                             f"{tuple(sd[k].shape)}, the model "
                             f"{tuple(want.shape)}")
        else:
            merged[k] = sd[k]
    model.load_state_dict(merged, strict=True)
    report = {"unmapped_torch_keys": unmapped,
              "missing_params": missing_p, "missing_stats": missing_s}
    if zoo:
        report["unused_torch_keys"] = unused
    return model, report
