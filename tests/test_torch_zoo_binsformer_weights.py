"""`ZooDepther` 'binsformer' weights in and out against the JAX package, on
the CPU: the params-only `.npz` both ways, and a reference `.pth` through
both packages' converters, with and without the released checkpoints' key
fix (`--binsformer-release`).

Widths, frames and tolerances as tests/test_torch_zoo_binsformer.py's.
The JAX forward is compiled once for the file (`_jax_eval`).
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_binsformer_textbook import released
from test_torch_zoo_binsformer import H, SHRINK, W, _final, binsformer
from test_torch_zoo_dpt import image, model_configs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def _jax_eval():
    """The JAX model's eval forward under `jax.jit`, one compile for every
    test here (the model's config is the same in all)."""
    jcfg, _ = model_configs("binsformer_nyu", **SHRINK)
    return jax.jit(jcfg.build().apply)


def test_zoo_binsformer_npz_both_ways(tmp_path):
    """The port's params-only `.npz` loads in the JAX `load_params_only`
    and gives the JAX model the port's outputs (the decoder's attention
    kernels split back into 8 heads); a JAX `.npz` loads into the port
    strictly and equal."""
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.train import checkpoint as tckpt

    img = image(seed=3, batch=2, h=H, w=W, channels=3)
    _, variables, tmodel = binsformer(img, seed=4)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"],
                           variables["batch_stats"])
    _, tcfg = model_configs("binsformer_nyu", **SHRINK)
    loaded = tckpt.load_params_only(path, tcfg.build())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    path = str(tmp_path / "port.npz")
    tmodel = tcfg.build(generator=torch.Generator().manual_seed(5))
    tckpt.save_params_only(path, tmodel)
    params, stats = jckpt.load_params_only(path, variables["params"],
                                           variables["batch_stats"])
    want = _jax_eval()({"params": params, "batch_stats": stats},
                       jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    _final(got, want, "npz")


@pytest.mark.parametrize("release", [False, True])
def test_zoo_binsformer_pth_loads_as_the_jax_converter(tmp_path, release):
    """A reference-keyed `.pth` of a whole BinsFormer (seeded weights under
    the reference's names, which the port's are, with what a reference
    file holds beside them: the encoder's unused `reference_points` layer,
    Swin's `relative_position_index` buffers, `num_batches_tracked`), in
    the released layout or not: both packages map every key, the port
    reports nothing unmapped, missing or unused, and both give the same
    outputs."""
    from gedepth_tpu.convert import (
        binsformer_release_remap, convert_state_dict as jax_convert)
    from gedepth_tpu.convert.torch_to_jax import _merge_into
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file

    _, tcfg = model_configs("binsformer_nyu", **SHRINK)
    source = tcfg.build(generator=torch.Generator().manual_seed(6))
    sd = dict(source.state_dict())
    g = torch.Generator().manual_seed(7)
    for name, t in list(sd.items()):          # statistics other than 0, 1
        if name.endswith("running_mean"):
            sd[name] = torch.randn(t.shape, generator=g) * 0.1
        elif name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
    sd["decode_head.transformer_encoder.reference_points.weight"] = \
        torch.randn(2, 32, generator=g)
    sd["decode_head.transformer_encoder.reference_points.bias"] = \
        torch.randn(2, generator=g)
    sd["backbone.stages.0.blocks.0.attn.w_msa.relative_position_index"] = \
        torch.zeros(49, 49, dtype=torch.long)
    if release:
        sd = released(sd)
    path = str(tmp_path / "binsformer.pth")
    torch.save({"state_dict": sd}, path)

    img = image(seed=8, batch=2, h=H, w=W, channels=3)
    _, variables, model = binsformer(img, seed=9)
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    if release:
        numpy_sd = binsformer_release_remap(numpy_sd)
    params, stats, jax_unmapped = jax_convert(numpy_sd)
    jparams, missing_p = _merge_into(variables["params"], params)
    jstats, missing_s = _merge_into(variables["batch_stats"], stats)
    assert not missing_p and not missing_s and not jax_unmapped
    _, report = convert_checkpoint_file(path, model,
                                        binsformer_release=release)
    assert report == {"unmapped_torch_keys": [], "missing_params": [],
                      "missing_stats": [], "unused_torch_keys": []}
    want = _jax_eval()({"params": jparams, "batch_stats": jstats},
                       jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    _final(got, want, "pth")
