"""The port's `tools.compat_check` against the JAX package's computation
(tools/compat_check.py), on the CPU, at the JAX test's tiny widths
(tests/test_compat_check.py) on a params-only `.npz` the JAX package wrote
from seeded weights.

Per radius the f32 delta against the exact forward and the clamp mass of
each deformable-attention layer agree within 1e-4, and the recommendation
read from the f32 columns is the same. The JAX tool's steps are taken here
through the JAX API (its CLI prints five decimals and no layer names). The
bf16 column is held to the port's own f32 delta only: XLA and PyTorch round
bf16 differently.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu.train.checkpoint import save_params_only as jax_save
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.tools import compat_check as cc

from test_torch_checkpoint import TINY
from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

PRESET = "gedepth_adaptive_kitti_parity"
RADII = (2, 8)


def _cfgs():
    jcfg, tcfg = jax_get_config(PRESET), get_config(PRESET)
    return tuple(c.replace(model=dataclasses.replace(c.model, **TINY),
                           data=dataclasses.replace(c.data,
                                                    eval_size=(64, 128)))
                 for c in (jcfg, tcfg))


class JaxSide:
    """tools/compat_check.py's table, computed once per radius: the exact
    f32 forward, then per radius the compat f32 forward with its sown clamp
    masses, by layer name."""

    def __init__(self, path, jcfg, variables):
        self.path, self.jcfg, self.variables = path, jcfg, variables
        self.img = cc.synthetic_scenes(1, 64, 128, seed=0)
        self._rows = {}
        self._ref = None

    def _run(self, mc):
        m = mc.build()
        ch = jnp.full((1,), mc.default_cam_height, jnp.float32)
        out, inter = jax.jit(functools.partial(
            m.apply, method=m.predict_depth, mutable=["intermediates"]))(
                self.variables, jnp.asarray(self.img), ch)
        return np.asarray(out).astype(np.float32), inter

    def row(self, R):
        mc = self.jcfg.model
        if self._ref is None:
            self._ref = self._run(dataclasses.replace(
                mc, neck_sampling="bilinear", bf16_scope="none"))[0]
        if R not in self._rows:
            d, inter = self._run(dataclasses.replace(
                mc, neck_window_radius=R, bf16_scope="none"))
            neck = inter["intermediates"]["neck"]
            self._rows[R] = {
                "radius": R,
                "delta_f32": float(np.mean(
                    np.abs(d - self._ref)
                    / np.maximum(self._ref, mc.min_depth))),
                "clamp_mass": {
                    "self_attn": float(
                        neck["self_attn"]["compat_clamp_mass"][0]),
                    "multi_att": float(
                        neck["cross_attn"]["compat_clamp_mass"][0])}}
        return self._rows[R]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    jcfg, _ = _cfgs()
    jmodel = jcfg.model.build()
    variables = _random_variables(jmodel.init, jnp.zeros((1, 64, 128, 5)),
                                  jnp.ones((1,)), seed=8)
    path = str(tmp_path_factory.mktemp("compat") / "tiny.npz")
    jax_save(path, variables["params"], variables["batch_stats"])
    return JaxSide(path, jcfg, variables)


@pytest.mark.parametrize("radius", RADII)
def test_compat_check_matches_jax(jax_side, radius):
    _, tcfg = _cfgs()
    (got,) = cc.compat_check(tcfg, jax_side.path, (radius,), images=1,
                             seed=0, device="cpu")
    ref = jax_side.row(radius)
    assert got["radius"] == radius
    assert abs(got["delta_f32"] - ref["delta_f32"]) < 1e-4, (got, ref)
    for layer, mass in ref["clamp_mass"].items():
        assert 0.0 <= got["clamp_mass"][layer] <= 1.0
        assert abs(got["clamp_mass"][layer] - mass) < 1e-4, (layer, got, ref)
    # bf16 scope: against the port's own f32 column only
    assert np.isfinite(got["delta_scope"])
    assert abs(got["delta_scope"] - got["delta_f32"]) < 2e-2


def test_recommendation_matches_jax(jax_side):
    """R = 2 clamps the seeded offsets hard and R = 8 hardly; the same
    recommendation from the f32 columns, for a budget between the two
    radii and for one neither clears."""
    _, tcfg = _cfgs()
    rows = cc.compat_check(tcfg, jax_side.path, RADII, images=1, seed=0,
                           device="cpu")
    want = [jax_side.row(R) for R in RADII]
    assert rows[1]["delta_f32"] <= rows[0]["delta_f32"]
    assert rows[1]["clamp_mass"]["multi_att"] < \
        rows[0]["clamp_mass"]["multi_att"]
    for budget in (np.sqrt(want[0]["delta_f32"] * want[1]["delta_f32"]),
                   1e-9):
        lines = [cc.recommendation(
            [dict(r, clears_f32=r["delta_f32"] < budget, clears_scope=False)
             for r in table], PRESET, "none", budget)
            for table in (rows, want)]
        assert lines[0] == lines[1], lines


def test_compat_check_needs_a_compat_preset(jax_side):
    cfg = get_config("gedepth_adaptive_kitti")
    with pytest.raises(ValueError, match="windowed_compat"):
        cc.compat_check(cfg, jax_side.path, RADII, device="cpu")
