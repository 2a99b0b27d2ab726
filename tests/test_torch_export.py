"""The port's serving export (`gedepth_tpu_torch.apis.export`) on the CPU.

Smoke widths (`smoke_synthetic`, 64x128, batch 1, flip-TTA), the exact
('bilinear') and the windowed neck. The weights are seeded numpy values of
the JAX model's variable tree, written by the JAX package's
`save_params_only` and exported through `checkpoint=`, as a user exports a
JAX checkpoint. The loaded program holds:

- the eager eval step of the port on the same weights, bit for bit (the
  program calls the same ops, kernels' plain versions included, in the
  same order; nothing in it reorders a sum on the CPU);
- the JAX package's `make_eval_step` on the same weights, at rtol 1e-4 and
  atol 1e-3 m (tests/test_torch_gedepth.py: f32 rounding taken in other
  orders, amplified by the adaptive prior).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.apis.export import (
    META, WEIGHTS, export_depther, load_exported, program_ops, save_exported)
from gedepth_tpu_torch.apis.inference import init_depther
from gedepth_tpu_torch.configs import get_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
H, W = 64, 128
SAMPLING = {"bilinear": dict(neck_sampling="bilinear"),
            "windowed": dict(neck_sampling="windowed", neck_hi_min_level=1)}
PORT_OPS = ["gedepth_torch::msda", "gedepth_torch::pe_fusion",
            "gedepth_torch::window_attention"]


def _configs(sampling):
    jcfg = jax_get_config("smoke_synthetic")
    tcfg = get_config("smoke_synthetic")
    return (jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                   **SAMPLING[sampling])),
            tcfg.replace(model=dataclasses.replace(tcfg.model,
                                                   **SAMPLING[sampling])))


def _sample(seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    img[..., 3] = rng.uniform(0, 1, (1, H, W))
    img[..., 4] = rng.uniform(2.0, 80.0, (1, H, W))
    return img


def _eager(tcfg, img, cam, **init):
    handle = init_depther(tcfg, device="cpu", **init)
    return handle.eval_step(torch.from_numpy(img),
                            torch.from_numpy(cam)).numpy()


@pytest.fixture(scope="module", params=sorted(SAMPLING))
def artifact(request, tmp_path_factory):
    """(sampling, configs, JAX variables, checkpoint, artifact dir)."""
    from gedepth_tpu.train.checkpoint import save_params_only
    from test_torch_gedepth import _random_variables

    jcfg, tcfg = _configs(request.param)
    jmodel = jcfg.model.build()
    variables = _random_variables(jmodel.init, jnp.zeros((1, H, W, 5)),
                                  jnp.ones((1,)), seed=3)
    root = tmp_path_factory.mktemp(f"export_{request.param}")
    npz = str(root / "params.npz")
    save_params_only(npz, variables["params"], variables["batch_stats"])
    exported, weights, meta = export_depther(tcfg, checkpoint=npz, hw=(H, W),
                                             device="cpu")
    save_exported(str(root / "art"), exported, weights, meta)
    return dict(sampling=request.param, jcfg=jcfg, tcfg=tcfg,
                variables=variables, npz=npz, dir=str(root / "art"),
                exported=exported, meta=meta)


def test_export_graph_holds_the_port_ops(artifact):
    """The program calls kernels A, B and E as the port's dispatcher ops,
    as often as the eager step does (5 Swin blocks, 2 deformable attentions,
    1 fusion a forward, twice with flip-TTA), and hands A its k and v as
    views into the packed qkv (selects, no copies)."""
    exported, meta = artifact["exported"], artifact["meta"]
    assert meta["ops"] == program_ops(exported) == PORT_OPS
    names = [(n, n.target.name()) for n in exported.graph.nodes
             if hasattr(n.target, "name")]
    counts = {op: sum(name == op for _, name in names) for op in PORT_OPS}
    assert counts == {"gedepth_torch::window_attention": 10,
                      "gedepth_torch::msda": 4, "gedepth_torch::pe_fusion": 2}
    for n, name in names:
        if name == "gedepth_torch::window_attention":
            k, v = n.args[1], n.args[2]
            assert {a.target.name() for a in (k, v)} == {"aten::select.int"}
    assert meta["input"] == {"img": [1, H, W, 5], "cam_height": [1]}
    assert meta["flip_tta"] and not meta["bf16"]
    assert meta["device"] == "cpu" and meta["torch_version"] == \
        torch.__version__
    saved = json.loads(Path(artifact["dir"], META).read_text())
    assert saved == meta


def test_served_equals_eager(artifact):
    """The loaded program against the port's eager eval step on the same
    weights and requests: bit for bit."""
    served = load_exported(artifact["dir"], device="cpu")
    for seed, h in ((0, None), (1, 1.52)):
        img = _sample(seed)
        cam = np.asarray([h or served.meta["default_cam_height"]], np.float32)
        got = served.predict(img, None if h is None else cam)
        want = _eager(artifact["tcfg"], img, cam, checkpoint=artifact["npz"])
        assert got.dtype == np.float32 and got.shape == (1, H, W)
        np.testing.assert_array_equal(got, want)


def test_served_matches_jax_eval_step(artifact):
    """The loaded program against `gedepth_tpu.train.steps.make_eval_step`
    on the same weights (flip-TTA, clamp, align_corners resize)."""
    from gedepth_tpu.train.steps import make_eval_step

    jmodel = artifact["jcfg"].model.build()
    step = make_eval_step(jmodel, flip_tta=True)
    img, cam = _sample(2), np.asarray([1.6], np.float32)
    want = np.asarray(step(artifact["variables"]["params"],
                           artifact["variables"]["batch_stats"],
                           {"img": jnp.asarray(img),
                            "cam_height": jnp.asarray(cam)}))
    got = load_exported(artifact["dir"], device="cpu").predict(img, cam)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_weights_swap(artifact, tmp_path):
    """The weights live outside the program: the seed-3 artifact with the
    port's seed-1 weights in weights.pt serves what the eager seed-1 model
    serves."""
    art = tmp_path / "art"
    shutil.copytree(artifact["dir"], art)
    model = artifact["tcfg"].model.build(
        generator=torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), art / WEIGHTS)
    img, cam = _sample(4), np.asarray([1.65], np.float32)
    got = load_exported(str(art), device="cpu").predict(img, cam)
    want = _eager(artifact["tcfg"], img, cam, seed=1)
    np.testing.assert_array_equal(got, want)
    before = load_exported(artifact["dir"], device="cpu").predict(img, cam)
    assert not np.array_equal(got, before)


def test_wrong_shape_raises(artifact):
    served = load_exported(artifact["dir"], device="cpu")
    for shape in ((1, H, W + 32, 5), (2, H, W, 5), (1, H, W, 3)):
        with pytest.raises(ValueError, match="shape"):
            served.predict(np.zeros(shape, np.float32))


LOADER = """
import json, sys
import numpy as np
import torch
from gedepth_tpu_torch.apis.export import load_exported
torch.set_num_threads(1)   # the test's thread count: the same sums
served = load_exported(sys.argv[1], device="cpu")
np.save(sys.argv[3], served.predict(np.load(sys.argv[2])))
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
      ("jax", "gedepth_tpu", "gedepth_tpu_torch"))))
"""


def test_load_without_model_code(artifact, tmp_path):
    """`load_exported` and `predict` in a fresh process import neither the
    port's models nor its configs, nor JAX nor the JAX package; the depth
    equals the eager step's."""
    img = _sample(5)
    np.save(tmp_path / "img.npy", img)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-c", LOADER, artifact["dir"],
         str(tmp_path / "img.npy"), str(tmp_path / "depth.npy")],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    modules = json.loads(run.stdout.strip().splitlines()[-1])
    for banned in ("gedepth_tpu_torch.models", "gedepth_tpu_torch.configs",
                   "jax", "gedepth_tpu"):
        assert banned not in modules, modules
    assert "gedepth_tpu_torch.ops.msda" in modules
    cam = np.asarray([artifact["meta"]["default_cam_height"]], np.float32)
    np.testing.assert_array_equal(
        np.load(tmp_path / "depth.npy"),
        _eager(artifact["tcfg"], img, cam, checkpoint=artifact["npz"]))
