"""The port's model zoo (ResNet, the BTS head, `ZooDepther` with 'bts' and
'densedepth') against the JAX package, on the CPU.

Seeded numpy variables for the JAX modules (`_random_variables`), carried
to the port with `state_dict_from_flax`; the same seeded inputs through
both. Tiny widths as tests/test_zoo_cli.py shrinks the zoo presets
(head_channels 8, 64x128, ResNet-18 or -50).

Tolerances: f32 on both sides, rtol 1e-4 (the torch-parity tolerance of
tests/test_parity_torch.py) with atol 1e-5 of each output's largest value
for features and BatchNorm statistics, 1e-3 m for depth. In train
mode flax's BatchNorm takes the variance in one pass (E[x²] − E[x]²), which
rounds more than torch's two passes: at ResNet-50's /16 and /32 levels the
JAX features lie ~2e-3 and ~4e-3 from a float64 evaluation (the port's,
~3e-4 and ~8e-4). There the port's train-mode features are held to JAX
within JAX's own distance from float64 on top of the tolerance above, and
to float64 at least as closely as JAX. Train steps
as tests/test_torch_train.py's: losses rtol 1e-4, parameters atol
2·lr·steps at lr 1e-6; the raw gradients, tensor by tensor,
||g_port − g_jax|| ≤ 1e-3·||g_jax|| + 1e-6 (the two-rank hold of
chip_smoke.py; the largest seen here is 1.4e-4, in the first ResNet
block, where the one-pass variance's rounding reaches the backward).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)

H, W = 64, 128
SHRINK = dict(head_channels=8)
ZOO_CASES = [("bts_kitti", "18"), ("bts_kitti", "50"),
             ("densedepth_kitti", "18")]


def _model_configs(name, **over):
    over = dict(SHRINK, **over)
    return (dataclasses.replace(jax_get_config(name).model, **over),
            dataclasses.replace(get_config(name).model, **over))


def _image(seed=0, batch=2):
    """A KITTI-like 5-channel input: normal RGB, clipped and raw PE (the
    zoo reads the first three only)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, H, W, 5)).astype(np.float32)
    img[..., 3] = rng.uniform(0, 1, (batch, H, W))
    img[..., 4] = rng.uniform(2.0, 80.0, (batch, H, W))
    return img


def _bridged(name, variant, img, seed=1, **over):
    """(JAX model, its variables, the port's model with them)."""
    jcfg, tcfg = _model_configs(name, backbone_variant=variant, **over)
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(img), None,
                                  seed=seed)
    tmodel = tcfg.build()
    tmodel.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, variables, tmodel


def _close(got, want, rtol=1e-4, atol_frac=1e-5, err_msg=""):
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_frac * float(np.abs(want).max()),
        err_msg=err_msg)


def _assert_stats_match(tmodel, batch_stats, f64_model, prefix=""):
    """The port's running statistics against JAX's, each within JAX's own
    distance from `f64_model`'s (the same forward in float64) on top of
    the tolerance; over all of them the port's distance from float64 is no
    larger than JAX's. `prefix`: the flax tree's top module, which the
    models' keys lack."""
    want = {k[len(prefix):]: v for k, v in state_dict_from_flax(
        {}, {prefix[:-1]: batch_stats} if prefix else batch_stats).items()}
    got, ref = tmodel.state_dict(), f64_model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    port_err = jax_err = 0.0
    for key in keys:
        g, w, r = (t[key].double().numpy() for t in (got, want, ref))
        e_jax = float(np.abs(w - r).max())
        port_err = max(port_err, float(np.abs(g - r).max()))
        jax_err = max(jax_err, e_jax)
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()) + e_jax,
            err_msg=key)
    assert port_err <= jax_err


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_matches_jax(depth):
    """The 5-level pyramid in eval and train mode, and the train-mode
    BatchNorm statistics, on bridged weights."""
    from gedepth_tpu.models.resnet import ResNet as JaxResNet
    from gedepth_tpu_torch.models.resnet import ResNet

    img = _image()[..., :3]
    jmodel = JaxResNet(depth=depth, include_stem=True)
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=2)
    sd = state_dict_from_flax({"backbone": variables["params"]},
                              {"backbone": variables["batch_stats"]})
    tmodel = ResNet(depth, include_stem=True).eval()
    tmodel.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                           strict=True)
    expansion = 1 if depth == 18 else 4
    channels = [64] + [64 * expansion * 2 ** i for i in range(4)]
    assert tmodel.channels == channels
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())

    want = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(x)
    for level, (g, w, c) in enumerate(zip(got, want, channels)):
        s = 2 ** (level + 1 if level == 0 else level + 1)
        assert g.shape == (2, c, H // s, W // s), (level, g.shape)
        _close(g.numpy().transpose(0, 2, 3, 1), w, err_msg=f"eval {level}")

    want, mutated = jmodel.apply(variables, jnp.asarray(img), True,
                                 mutable=["batch_stats"])
    f64 = _double_copy(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
        ref = f64(x.double())
    for level, (g, w, r) in enumerate(zip(got, want, ref)):
        g = g.numpy().transpose(0, 2, 3, 1)
        w, r = np.asarray(w), r.numpy().transpose(0, 2, 3, 1)
        jax_err = float(np.abs(w - r).max())
        assert float(np.abs(g - r).max()) <= jax_err, level
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()) + jax_err,
            err_msg=f"train {level}")
    _assert_stats_match(tmodel, mutated["batch_stats"], f64, "backbone.")


def test_local_planar_guidance():
    """A fronto-parallel plane (normal (0, 0, 1), distance d) gives depth d
    at every sub-pixel; a random plane field equals the JAX function's."""
    from gedepth_tpu.models.bts import local_planar_guidance as jax_lpg
    from gedepth_tpu_torch.models.bts import local_planar_guidance

    flat = torch.zeros(2, 4, 3, 5)
    flat[:, 2] = 1.0
    flat[:, 3] = torch.arange(1.0, 16.0).reshape(3, 5)
    for r in (2, 4, 8):
        got = local_planar_guidance(flat, r)
        assert got.shape == (2, 3 * r, 5 * r)
        want = flat[:, 3].repeat_interleave(r, 1).repeat_interleave(r, 2)
        assert torch.equal(got, want), r

    rng = np.random.default_rng(3)
    eq = rng.normal(0, 0.3, (2, 4, 3, 5)).astype(np.float32)
    eq[:, 2] += 1.0
    eq[:, 3] = rng.uniform(1, 80, (2, 3, 5))
    for r in (2, 4, 8):
        want = jax_lpg(jnp.asarray(eq.transpose(0, 2, 3, 1)), r)
        got = local_planar_guidance(torch.from_numpy(eq), r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0, err_msg=str(r))


def test_nearest_index_is_the_jax_rule():
    """The float64 floor(o·in/out) of `gedepth_tpu.ops.resize`, at the
    head's sizes and at sizes where a single-precision scale can differ."""
    from gedepth_tpu.ops.resize import _nearest_weights
    from gedepth_tpu_torch.ops.resize import nearest_index

    for n_in, n_out in ((11, 22), (38, 76), (352, 88), (1216, 304),
                        (176, 44), (608, 152), (7, 3), (1000, 999),
                        (999, 1000), (33, 100), (100, 33)):
        want = np.argmax(_nearest_weights(n_in, n_out), axis=1)
        assert np.array_equal(nearest_index(n_in, n_out).numpy(), want), \
            (n_in, n_out)


def test_bts_head_matches_jax():
    """The head alone at the widths of tests/test_parity_bts.py (num
    features 128), bridged from seeded JAX variables, eval mode."""
    from gedepth_tpu.models.bts import BTSHead as JaxBTSHead
    from gedepth_tpu_torch.models.bts import BTSHead
    from test_torch_bts_textbook import (
        FEAT_CH, MAX_DEPTH, MIN_DEPTH, NF, pyramid)

    feats = pyramid(seed=4, batch=2)
    jhead = JaxBTSHead(in_channels=FEAT_CH, num_features=NF,
                       max_depth=MAX_DEPTH, min_depth=MIN_DEPTH)
    variables = _random_variables(
        jhead.init, [jnp.asarray(f) for f in feats], seed=5)
    sd = state_dict_from_flax({"decode_head": variables["params"]},
                              {"decode_head": variables["batch_stats"]})
    head = BTSHead(FEAT_CH, NF, MAX_DEPTH, MIN_DEPTH).eval()
    head.load_state_dict({k[len("decode_head."):]: v for k, v in sd.items()},
                         strict=True)
    want = jhead.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = head([torch.from_numpy(f.transpose(0, 3, 1, 2).copy())
                    for f in feats])
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,variant", ZOO_CASES)
def test_zoo_depther_matches_jax(name, variant):
    """Eval forward, `predict_depth`, the train-mode forward and its
    BatchNorm statistics."""
    img = _image()
    jmodel, variables, tmodel = _bridged(name, variant, img)
    want = jmodel.apply(variables, jnp.asarray(img))
    want_pred = jmodel.apply(variables, jnp.asarray(img),
                             method=jmodel.predict_depth)
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = tmodel(x)
        got_pred = tmodel.predict_depth(x)
    assert got["y"] is None and got["slope_logits"] is None
    assert got["pe_mask"] is None
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    assert got_pred.shape == (2, H, W, 1)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-3)

    want, mutated = jmodel.apply(variables, jnp.asarray(img), None, True,
                                 mutable=["batch_stats"])
    f64 = _double_copy(tmodel)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(x)
        f64(x.double())
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)
    _assert_stats_match(tmodel, mutated["batch_stats"], f64)


def _double_copy(model):
    """A float64 copy of `model` in train mode."""
    import copy

    return copy.deepcopy(model).double().train()


def test_zoo_reads_rgb_only():
    """The PE channels of the input change nothing: the zoo keeps
    img[..., :3] (the JAX ZooDepther), with the preset's pe_variant left
    'adaptive' for the loader."""
    _, tcfg = _model_configs("bts_kitti", backbone_variant="18")
    assert tcfg.pe_variant == "adaptive"
    model = tcfg.build()
    assert model.pe_variant == "none"
    img = _image()
    other = img.copy()
    other[..., 3:] = np.random.default_rng(9).uniform(0, 50, other[..., 3:]
                                                      .shape)
    with torch.no_grad():
        a = model(torch.from_numpy(img))["depth"]
        b = model(torch.from_numpy(other))["depth"]
        c = model(torch.from_numpy(img[..., :3].copy()))["depth"]
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("arch", ["segformer"])
def test_unported_archs_raise(arch):
    """Every arch of the JAX zoo is ported ('seg' since the seg model
    came); an arch that neither package knows raises."""
    from gedepth_tpu_torch.models.zoo import ZOO_ROADMAP

    assert not ZOO_ROADMAP
    _, tcfg = _model_configs("bts_kitti")
    with pytest.raises(NotImplementedError, match="unknown arch"):
        dataclasses.replace(tcfg, arch=arch).build()


def _synthetic_batches(steps, batch=2, seed=0):
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(H, W))
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=H, width=W),
                         build_train_pipeline(data), batch, seed=seed)
    return [loader.make_batch(s) for s in range(steps)]


def _jax_zoo_grads(jmodel, variables, batch, weight):
    """The raw gradients of the loss `make_zoo_train_step` takes."""
    from gedepth_tpu.models.losses import sigloss
    from gedepth_tpu.ops.resize import resize_bilinear

    gt = jnp.asarray(batch["depth_gt"])[..., None]

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["img"]), None, True, mutable=["batch_stats"])
        d = resize_bilinear(out["depth"], gt.shape[1:3], align_corners=True)
        return weight * sigloss(d, gt)

    return jax.jit(jax.grad(loss_fn))(variables["params"])


@pytest.mark.parametrize("name", ["bts_kitti", "densedepth_kitti"])
def test_zoo_train_step_matches_jax(name):
    """One step of `make_zoo_train_step` on both sides from the same
    weights and batch (ResNet-18, batch 2, 64x128): loss; gradient norm
    and raw gradients, tensor by tensor; then BatchNorm statistics and
    parameters. The gradient norm is held within JAX's own distance from
    a float64 evaluation of the port's step on top of rtol 1e-4 (the one-
    pass variance again: 3.1e-4 relative for JAX, 1.1e-4 for the port, at
    the BTS head here), and the port's distance is no larger than JAX's."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_zoo_train_step as jax_step
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState, make_zoo_train_step

    weight = get_config(name).optim.sig_loss_weight
    lr = 1e-6
    batch = _synthetic_batches(1)[0]
    # head_channels 32: every read of the BTS head's Reduction1x1 in bounds
    # (below, the JAX head clamps an index in the forward and drops its
    # gradient in the backward; models/bts.py)
    jmodel, variables, model = _bridged(name, "18", batch["img"], seed=6,
                                        head_channels=32)
    jgrads = state_dict_from_flax(
        _jax_zoo_grads(jmodel, variables, batch, weight))
    tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
               for k in ("img", "depth_gt", "cam_height")}
    f64 = _double_copy(model)
    f64_state = TrainState(f64, toptim.make_optimizer(f64),
                           toptim.lr_schedule(lr, 10, 0))
    f64_norm = make_zoo_train_step(weight)(
        f64_state, {k: v.double() for k, v in tensors.items()})["grad_norm"]

    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jm = jax_step(jmodel, sig_loss_weight=weight, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(lr, 10, 0))
    tm = make_zoo_train_step(weight)(state, tensors)
    assert set(tm) == {"loss", "loss_depth", "grad_norm", "lr"}
    for key in ("loss", "loss_depth"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
    norm, jnorm = tm["grad_norm"].item(), float(jm["grad_norm"])
    jax_err = abs(jnorm - f64_norm.item())
    assert abs(norm - f64_norm.item()) <= jax_err
    np.testing.assert_allclose(norm, jnorm, rtol=1e-4, atol=jax_err)
    # the gradients before the clip (35, both sides)
    unclip = max(norm, 35.0) / 35.0
    for pname, p in model.named_parameters():
        g, want = p.grad * unclip, jgrads[pname]
        assert torch.linalg.vector_norm(g - want) <= (
            1e-3 * torch.linalg.vector_norm(want) + 1e-6), pname

    want = state_dict_from_flax(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(want) == set(got)
    _assert_stats_match(model, jax.device_get(jstate.batch_stats), f64)
    moved = total = 0
    for key, value in want.items():
        if key.endswith(("num_batches_tracked", "running_mean",
                         "running_var")):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=0, atol=2 * lr, err_msg=key)
        moved += int((np.abs((value - before[key]).numpy()) > lr / 2).sum())
        total += value.numel()
    assert moved > 0.5 * total


@pytest.mark.parametrize("name", ["bts_kitti", "densedepth_kitti",
                                  "binsformer_nyu"])
def test_zoo_decay_mask_matches_jax(name):
    """`optim.decays` over the zoo's parameter names equals the JAX
    `decay_mask` over the bridged tree (every BatchNorm decays; in
    BinsFormer its Swin's and transformers' LayerNorms and bias tables do
    not, its `decoder_norm` does)."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu_torch.convert.from_jax import _torch_name
    from gedepth_tpu_torch.train import optim as toptim

    jcfg, tcfg = _model_configs(name, backbone_variant="18")
    variables = _random_variables(jcfg.build().init,
                                  jnp.zeros((1, H, W, 5)), None)
    mask = joptim.decay_mask(variables["params"])
    seen = {}
    for path, decayed in jax.tree_util.tree_flatten_with_path(mask)[0]:
        name_ = _torch_name([getattr(p, "key", str(p)) for p in path])
        seen[name_] = bool(decayed)
        assert toptim.decays(name_) == bool(decayed), name_
    assert set(seen) == {n for n, _ in tcfg.build().named_parameters()}
    assert all(seen.values()) == (name != "binsformer_nyu")
    if name == "binsformer_nyu":
        # the encoder's and decoder's norm1-norm3 (the port's `norms.N`)
        # go without decay; `decoder_norm`, the level embeds and the
        # queries decay
        dec = "decode_head.transformer_decoder."
        for key in (dec + "decoder_norm.weight",
                    "decode_head.level_embed.weight",
                    "decode_head.transformer_encoder.level_embeds",
                    "decode_head.query_feat.weight",
                    "decode_head.query_embed.weight"):
            assert seen[key], key
        assert not seen[dec + "layers.0.norms.2.weight"]


@pytest.mark.parametrize("name", ["bts_kitti", "densedepth_kitti"])
def test_zoo_npz_both_ways(name, tmp_path):
    """The port's params-only `.npz` loads in the JAX `load_params_only`
    and gives the JAX model the port's depth; a JAX `.npz` loads into the
    port strictly."""
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.train import checkpoint as tckpt

    img = _image(batch=1)
    jmodel, variables, tmodel = _bridged(name, "18", img, seed=7)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"],
                           variables["batch_stats"])
    _, tcfg = _model_configs(name, backbone_variant="18")
    loaded = tckpt.load_params_only(path, tcfg.build())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    path = str(tmp_path / "port.npz")
    tmodel = tcfg.build(generator=torch.Generator().manual_seed(11))
    tckpt.save_params_only(path, tmodel)
    params, stats = jckpt.load_params_only(
        path, variables["params"], variables["batch_stats"])
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)


def test_zoo_pth_keys_follow_the_jax_converter(tmp_path):
    """A reference-named zoo `.pth` (a textbook BTS head under
    `decode_head.`, a ResNet-18 under `backbone.`): the port loads what
    the JAX converter maps (the head) and keeps the seeded backbone, as
    JAX does; both report the same unmapped keys (`backbone.layer*`), and
    the stem keys that JAX sends to GEDepth's conv stem are the port's
    unused ones."""
    from gedepth_tpu.convert import convert_state_dict as jax_convert
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file
    from gedepth_tpu_torch.models.resnet import ResNet
    from test_torch_bts_textbook import TBTSHead

    torch.manual_seed(0)
    backbone = ResNet(18, include_stem=True)
    head = TBTSHead(backbone.channels, 128, 80.0, 1e-3)
    sd = {f"decode_head.{k}": v for k, v in head.state_dict().items()}
    sd.update({f"backbone.{k}": v for k, v in backbone.state_dict().items()})
    path = str(tmp_path / "zoo.pth")
    torch.save({"state_dict": sd}, path)

    _, tcfg = _model_configs("bts_kitti", backbone_variant="18",
                             head_channels=32)
    model = tcfg.build(generator=torch.Generator().manual_seed(3))
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, jax_unmapped = jax_convert({k: v.numpy() for k, v in sd.items()})
    _, report = convert_checkpoint_file(path, model)
    assert sorted(report["unmapped_torch_keys"]) == sorted(jax_unmapped)
    assert jax_unmapped and all(k.startswith("backbone.layer")
                                for k in jax_unmapped)
    assert report["unused_torch_keys"] == [
        "backbone.bn1.bias", "backbone.bn1.running_mean",
        "backbone.bn1.running_var", "backbone.bn1.weight",
        "backbone.conv1.weight"]
    assert sorted(report["missing_params"]) == sorted(
        k for k, _ in model.named_parameters() if k.startswith("backbone."))
    got = model.state_dict()
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        want = v if k.startswith("decode_head.") else seeded[k]
        assert torch.equal(got[k], want), k
