"""The port's reference `.pth` loader against
`gedepth_tpu.convert.torch_to_jax`, on the CPU.

The file is written here from a seeded model in the reference's format
(`{"state_dict": {"module." + key: tensor}}` with the
`relative_position_index` buffers and `num_batches_tracked` counters a
reference save holds, one key of another model, some keys left out); both
packages load it and must give the same unmapped/missing report and the
same depth (f32, rtol 1e-4, atol 1e-3 m, as tests/test_torch_gedepth.py).
The keys left out are a BatchNorm's scale and statistics, which both
packages initialise to 1 and 0 alike. A 3-channel patch embed is padded
alike, window-12 tables are resized as `bicubic_resize_torch` resizes them
(atol 1e-6), and official Swin keys are renamed and reordered alike.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.convert import torch_to_jax as jconv
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import from_pth, state_dict_from_flax
from gedepth_tpu_torch.convert.from_jax import _torch_name
from gedepth_tpu_torch.models.swin import relative_position_index

from test_torch_checkpoint import TINY, _jax_depth, _port_depth
from test_torch_gedepth import _random_variables, _sample

torch.set_num_threads(1)

H, W = 64, 128
LEFT_OUT = ("neck.conv_proj.0.bn.weight", "neck.conv_proj.0.bn.running_mean",
            "neck.conv_proj.0.bn.running_var")


def _models(**over):
    """The JAX and the port model of one tiny configuration (exact
    sampling: the tree with `neck.reference_points`)."""
    over = dict(TINY, neck_sampling="bilinear", **over)
    jcfg = dataclasses.replace(jax_get_config("smoke_synthetic").model,
                               swin_scan=False, **over)
    tcfg = dataclasses.replace(get_config("smoke_synthetic").model, **over)
    return jcfg.build(), tcfg


def _reference_file(path, sd, window):
    """Save `sd` as a reference training checkpoint would hold it."""
    out = {"module." + k: v for k, v in sd.items()}
    index = torch.from_numpy(relative_position_index(window, window))
    for k in sd:
        if k.endswith("attn.w_msa.relative_position_bias_table"):
            out["module." + k.replace("bias_table", "index")] = index
    torch.save({"meta": {"iter": 100}, "state_dict": out}, path)


@pytest.mark.parametrize("pe_variant", ["adaptive", "none"])
def test_reference_pth_loads_as_in_jax(tmp_path, pe_variant):
    jmodel, tcfg = _models(pe_variant=pe_variant)
    c = 5 if pe_variant != "none" else 3
    img = _sample(np.random.default_rng(2), H, W)[..., :c]
    cam = np.asarray([1.6], np.float32)
    variables = _random_variables(jmodel.init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=3)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    for k in LEFT_OUT:
        del sd[k]
    sd["auxiliary_head.conv_seg.weight"] = torch.zeros(2, 4, 1, 1)
    path = str(tmp_path / "ref.pth")
    _reference_file(path, sd, tcfg.window)

    model, report = from_pth.convert_checkpoint_file(path, tcfg.build())
    # the JAX function as it is; its model's init (which would compile the
    # whole model once more) gives a tree of the init's shapes holding flax's
    # BatchNorm init, scale 1, mean 0, var 1, where the file leaves keys out
    init = jax.tree.map(np.copy, variables)
    bn = ("neck", "conv_proj", "BatchNorm_0")
    init["params"][bn[0]][bn[1]][bn[2]]["scale"][:] = 1
    init["batch_stats"][bn[0]][bn[1]][bn[2]]["mean"][:] = 0
    init["batch_stats"][bn[0]][bn[1]][bn[2]]["var"][:] = 1
    jparams, jstats, jreport = jconv.convert_checkpoint_file(
        path, types.SimpleNamespace(init=lambda *args: init),
        jnp.asarray(img), jnp.asarray(cam), use_pe=pe_variant != "none")

    assert report["unmapped_torch_keys"] == jreport["unmapped_torch_keys"] \
        == ["auxiliary_head.conv_seg.weight"]
    for ours, theirs in (("missing_params", "missing_params"),
                         ("missing_stats", "missing_stats")):
        assert sorted(report[ours]) == sorted(
            _torch_name(p.split("/")) for p in jreport[theirs])
    assert sorted(report["missing_params"] + report["missing_stats"]) == \
        sorted(LEFT_OUT)
    np.testing.assert_allclose(
        _port_depth(model, img, cam),
        _jax_depth(jmodel, {"params": jparams, "batch_stats": jstats}, img,
                   cam),
        rtol=1e-4, atol=1e-3)


def test_three_channel_patch_embed_is_padded_as_in_jax(tmp_path):
    """An RGB patch embed goes into the 4-channel model with a zero 4th
    channel, as the JAX converter pads it."""
    _, tcfg = _models()
    source = tcfg.build(generator=torch.Generator().manual_seed(4))
    sd = dict(source.state_dict())
    key = "backbone.patch_embed.projection.weight"
    sd[key] = sd[key][:, :3].clone()
    path = str(tmp_path / "rgb.pth")
    _reference_file(path, sd, tcfg.window)

    model, report = from_pth.convert_checkpoint_file(path, tcfg.build())
    assert report == {"unmapped_torch_keys": [], "missing_params": [],
                      "missing_stats": []}
    got = model.state_dict()[key]
    assert got.shape[1] == 4 and not got[:, 3].any()
    assert torch.equal(got[:, :3], sd[key])
    jparams, _, _ = jconv.convert_state_dict(
        jconv.load_torch_checkpoint(path))
    jconv.pad_patch_embed_for_pe(jparams)
    jkernel = jparams["backbone"]["patch_embed"]["projection"]["kernel"]
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), jkernel)


def test_window12_tables_resized_as_in_jax():
    """Tables of window 12 ((23·23, nH)) into a window-7 model's (13·13,
    nH): `F.interpolate` bicubic against the JAX package's
    `bicubic_resize_torch`; another head count is left alone."""
    rng = np.random.default_rng(5)
    t12 = rng.normal(0, 0.5, (23 * 23, 4)).astype(np.float32)
    other = rng.normal(0, 0.5, (23 * 23, 3)).astype(np.float32)
    k0 = "backbone.stages.0.blocks.0.attn.w_msa.relative_position_bias_table"
    k1 = "backbone.stages.1.blocks.0.attn.w_msa.relative_position_bias_table"
    sd = {k0: torch.from_numpy(t12), k1: torch.from_numpy(other)}
    model_sd = {k0: torch.zeros(13 * 13, 4), k1: torch.zeros(13 * 13, 4)}
    from_pth.resize_swin_pos_tables(sd, model_sd)

    conv = {"stage0_block0": {"attn": {"relative_position_bias_table": t12}},
            "stage1_block0": {"attn": {"relative_position_bias_table":
                                       other}}}
    tmpl = {b: {"attn": {"relative_position_bias_table":
                         np.zeros((13 * 13, 4), np.float32)}}
            for b in ("stage0_block0", "stage1_block0")}
    jconv.resize_swin_pos_tables(conv, tmpl)
    want = conv["stage0_block0"]["attn"]["relative_position_bias_table"]
    assert sd[k0].shape == want.shape == (169, 4)
    np.testing.assert_allclose(sd[k0].numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(sd[k1], torch.from_numpy(other))


def test_swin_official_keys_as_in_jax():
    """A synthetic official Swin dict: the same keys, the same values (the
    PatchMerging reorder included), the classifier head dropped."""
    rng = np.random.default_rng(6)
    shapes = {
        "patch_embed.proj.weight": (8, 3, 4, 4), "patch_embed.proj.bias": (8,),
        "patch_embed.norm.weight": (8,),
        "layers.0.blocks.0.norm1.weight": (8,),
        "layers.0.blocks.0.attn.qkv.weight": (24, 8),
        "layers.0.blocks.0.attn.qkv.bias": (24,),
        "layers.0.blocks.0.attn.proj.weight": (8, 8),
        "layers.0.blocks.0.attn.relative_position_bias_table": (169, 2),
        "layers.0.blocks.0.mlp.fc1.weight": (32, 8),
        "layers.0.blocks.0.mlp.fc2.weight": (8, 32),
        "layers.0.downsample.reduction.weight": (16, 32),
        "layers.0.downsample.norm.weight": (32,),
        "layers.0.downsample.norm.bias": (32,),
        "norm.weight": (8,), "head.weight": (10, 8), "head.bias": (10,)}
    official = {k: rng.normal(size=s).astype(np.float32)
                for k, s in shapes.items()}
    official["layers.0.blocks.0.attn.relative_position_index"] = \
        relative_position_index(7, 7)
    got = from_pth.swin_official_to_gedepth(
        {k: torch.from_numpy(v) for k, v in official.items()})
    want = jconv.swin_official_to_gedepth(official)
    assert set(got) == set(want)
    assert not any(k.startswith("head.") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # and the key filter: kept, dropped and unmapped as the JAX mapping
    for k in got:
        key = "backbone." + k
        rule = from_pth.reference_key_rule(key)
        mapped = jconv._map_torch_key(key)
        assert rule is (None if mapped is None else bool(mapped)), key
