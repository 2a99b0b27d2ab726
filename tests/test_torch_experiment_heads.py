"""The port's experiment heads (`models.experiment_heads`: pixel-adaptive
convolution, `PacConv`, `depth_to_normals`, `GuidanceHead`,
`ASNDepthHead`) against the JAX package's, on the CPU, on carried weights
(`convert.from_jax.load_flax_variables`, and back): f32 on both sides at
rtol 1e-4, atol 1e-5 of each output's largest magnitude where it is not
O(1), as elsewhere in the port (tests/test_torch_asn.py's helpers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.models import experiment_heads as jax_heads
from gedepth_tpu_torch.models import experiment_heads as heads

from test_torch_asn import UP, _carry, _close, _pyramid, _t, _variables

torch.set_num_threads(1)


def test_pixel_adaptive_conv_and_pac_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 12, 5)).astype(np.float32)
    guide = rng.standard_normal((2, 10, 12, 3)).astype(np.float32) * 0.7
    kernel = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    _close(heads.pixel_adaptive_conv(_t(x), _t(guide), _t(kernel)),
           jax_heads.pixel_adaptive_conv(jnp.asarray(x), jnp.asarray(guide),
                                         jnp.asarray(kernel)))
    ref = jax_heads.PacConv(6)
    variables = _variables(ref, jnp.asarray(x), jnp.asarray(guide))
    port = _carry(heads.PacConv(5, 6), variables)
    _close(port(_t(x), _t(guide)),
           ref.apply(variables, jnp.asarray(x), jnp.asarray(guide)))


def test_depth_to_normals_wraps_as_jax():
    rng = np.random.default_rng(7)
    depth = rng.uniform(0.5, 5.0, (2, 9, 11, 1)).astype(np.float32)
    depth[0, 0, 0, 0] = 0.0
    got = heads.depth_to_normals(_t(depth), 50.0, 55.0)
    want = jax_heads.depth_to_normals(jnp.asarray(depth), 50.0, 55.0)
    _close(got, want)
    # the first column's difference reads the last column (no padding)
    d = depth[1, 3, :, 0]
    n = np.array([-(d[1] - d[-1]) * 0.5 * 50.0 / d[0],
                  -(depth[1, 4, 0, 0] - depth[1, 2, 0, 0]) * 0.5 * 55.0
                  / d[0], 1.0])
    _close(got[1, 3, 0], n / np.linalg.norm(n))


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_guidance_head_matches_jax(use_sigmoid):
    feats = _pyramid()
    ref = jax_heads.GuidanceHead(UP, use_sigmoid=use_sigmoid)
    variables = _variables(ref, [jnp.asarray(f) for f in feats])
    port = _carry(heads.GuidanceHead(UP, use_sigmoid=use_sigmoid),
                  variables)
    got = port([_t(f) for f in feats])
    want = ref.apply(variables, [jnp.asarray(f) for f in feats])
    assert got.shape == (2, 16, 24, 1)
    _close(got, want)


def test_asn_depth_head_matches_jax():
    feats = _pyramid(seed=8)
    ref = jax_heads.ASNDepthHead(UP, channels=8, focal=50.0)
    variables = _variables(ref, [jnp.asarray(f) for f in feats])
    port = _carry(heads.ASNDepthHead(UP, channels=8, focal=50.0), variables)
    depth, normals = port([_t(f) for f in feats])
    want_d, want_n = ref.apply(variables, [jnp.asarray(f) for f in feats])
    assert depth.shape == (2, 16, 24, 1) and normals.shape == (2, 16, 24, 3)
    _close(depth, want_d)
    _close(normals, want_n)


def test_head_rule_only_for_head_trees():
    """The experiment heads' naming rule applies only to a tree whose top
    names are all a head's: a model's key with such a top module, beside
    a model's own (`classifier`), still raises KeyError both ways."""
    from gedepth_tpu_torch.convert.from_jax import (
        flax_variables_from_state_dict, is_head_tree, state_dict_from_flax)

    assert is_head_tree(["conv0", "up1", "guide", "pac", "conv_depth"])
    assert is_head_tree(["kernel", "bias"])
    assert not is_head_tree(["classifier", "fuse1"])
    assert not is_head_tree([])
    kernel = np.zeros((1, 1, 2, 3), np.float32)
    with pytest.raises(KeyError, match="fuse1/Conv_0/kernel"):
        state_dict_from_flax({"classifier": {"kernel": kernel[0, 0]},
                              "fuse1": {"Conv_0": {"kernel": kernel}}})
    with pytest.raises(KeyError, match="fuse1.conv.weight"):
        flax_variables_from_state_dict({
            "classifier.weight": torch.zeros(3, 2),
            "fuse1.conv.weight": torch.zeros(3, 2, 1, 1)})
