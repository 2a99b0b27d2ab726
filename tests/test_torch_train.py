"""The PyTorch port's training path against the JAX package, on the CPU.

Losses, the LR schedule, the weight-decay mask and one clipped AdamW update
against `gedepth_tpu.models.losses`, `gedepth_tpu.train.optim` and optax;
BatchNorm running statistics against flax; dropout and DropPath from an
explicit generator; three train steps at smoke width against
`gedepth_tpu.train.steps.make_train_step`. Seeded numpy inputs on both
sides, f32. Tolerances: losses and their input gradients rtol 1e-5, the
schedule and the optimizer update rtol 1e-6 (the same f32 arithmetic in
another order), BatchNorm statistics rtol 1e-5; train-step losses and
gradient norms rtol 1e-4 (a whole model's f32 rounding, as in
tests/test_torch_gedepth.py), parameters atol 2·lr·steps (an Adam update is
≈ lr·sign(g), and a gradient within rounding of zero may take either sign in
the two frameworks).

The train steps run at lr 1e-6. About 0.02% of the gradient elements of the
smoke model lie within rounding of zero, and Adam moves each of them by
±lr with the sign of its rounding. At the smoke size the last Swin stage is
2x4 (16 values per channel in its BatchNorm), which turns those flips at
lr 1e-4 into a 1e-3 change of the next step's gradient norm. At lr 1e-6 the
effect stays under 1e-4, and each parameter still moves by ~lr per step:
the test checks the two updates element by element.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from gedepth_tpu.models import losses as jlosses
from gedepth_tpu.train import optim as joptim
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models import losses as tlosses
from gedepth_tpu_torch.models.layers import ConvModule, Dropout, Stochastic
from gedepth_tpu_torch.train import optim as toptim
from gedepth_tpu_torch.train.steps import (
    TrainState, create_train_state, make_train_step)

from test_torch_gedepth import _random_variables

torch.set_num_threads(1)


def _smoke_model_configs(**over):
    from gedepth_tpu.configs import get_config as jax_get_config

    over = dict(neck_sampling="windowed", neck_hi_min_level=1, **over)
    return (dataclasses.replace(jax_get_config("smoke_synthetic").model,
                                **over),
            dataclasses.replace(get_config("smoke_synthetic").model, **over))


def _depth_batch(rng, B=2, H=16, W=24):
    pred = rng.uniform(0.5, 60.0, (B, H, W, 1)).astype(np.float32)
    gt = rng.uniform(1.0, 80.0, (B, H, W, 1)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.6] = 0.0
    return pred, gt


def test_sigloss_matches_jax():
    pred, gt = _depth_batch(np.random.default_rng(0))
    want, want_grad = jax.value_and_grad(
        lambda p: jlosses.sigloss(p, jnp.asarray(gt)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tlosses.sigloss(p, torch.from_numpy(gt))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-9)


def test_softmax_ce_ignore_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 8, 12, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 8, 12)).astype(np.float32)
    labels[:, :3] = 255
    want, want_grad = jax.value_and_grad(
        lambda l: jlosses.softmax_ce_ignore(l, jnp.asarray(labels)))(
            jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tlosses.softmax_ce_ignore(lg, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("warmup", [0, 100])
def test_lr_schedule_matches_jax(warmup):
    args = (1e-4, 1000, warmup, 1e-3, 1e-8)
    jsched, tsched = joptim.lr_schedule(*args), toptim.lr_schedule(*args)
    for step in (0, 1, max(warmup - 1, 0), warmup, 500, 999, 1000):
        np.testing.assert_allclose(tsched(step),
                                   float(jsched(jnp.asarray(step))),
                                   rtol=1e-6, err_msg=str(step))


def test_decay_mask_matches_jax():
    """Every flax leaf of a smoke GEDepth, mapped to its torch name: the
    port's decay group equals `gedepth_tpu.train.optim.decay_mask`; norms
    and bias tables do not decay, BatchNorm and biases do."""
    from gedepth_tpu_torch.convert.from_jax import _torch_name

    jcfg, tcfg = _smoke_model_configs()
    variables = _random_variables(jcfg.build().init,
                                  jnp.zeros((1, 64, 128, 5)), jnp.ones((1,)))
    mask = joptim.decay_mask(variables["params"])
    seen = {}
    for path, decayed in jax.tree_util.tree_flatten_with_path(mask)[0]:
        name = _torch_name([getattr(p, "key", str(p)) for p in path])
        seen[name] = bool(decayed)
        assert toptim.decays(name) == bool(decayed), name
    model = tcfg.build()
    assert set(seen) == {n for n, _ in model.named_parameters()}
    assert not seen["backbone.stages.0.blocks.0.norm1.weight"]
    assert not seen["backbone.norm3.bias"]
    assert not seen["backbone.stages.0.blocks.0.attn.w_msa."
                    "relative_position_bias_table"]
    assert seen["backbone.bn1.weight"] and seen["neck.conv_proj.0.bn.bias"]
    groups = toptim.make_optimizer(model).param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert sum(len(g["params"]) for g in groups) == len(seen)


def test_clipped_adamw_matches_optax():
    """Two updates of a small tree, gradients past the clip norm, against
    optax's clip_by_global_norm + adamw with the decay mask."""
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (3, 4)).astype(np.float32)
    params = {"proj": {"kernel": w.T.copy(),
                       "bias": rng.normal(0, 1, 3).astype(np.float32)},
              "norm": {"scale": rng.normal(1, 0.1, 3).astype(np.float32),
                       "bias": rng.normal(0, 1, 3).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(0, 20, p.shape).astype(
        np.float32), params) for _ in range(2)]
    tx, _ = joptim.make_optimizer(1e-2, 10, 3)
    jp, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    module = torch.nn.ModuleDict({"proj": torch.nn.Linear(4, 3),
                                  "norm": torch.nn.LayerNorm(3)})
    tparams = {"proj.weight": w, "proj.bias": params["proj"]["bias"],
               "norm.weight": params["norm"]["scale"],
               "norm.bias": params["norm"]["bias"]}
    module.load_state_dict({k: torch.from_numpy(v.copy())
                            for k, v in tparams.items()})
    state = TrainState(module, toptim.make_optimizer(module),
                       toptim.lr_schedule(1e-2, 10, 3))
    norms = []
    for g in grads:
        tg = {"proj.weight": g["proj"]["kernel"].T, "proj.bias":
              g["proj"]["bias"], "norm.weight": g["norm"]["scale"],
              "norm.bias": g["norm"]["bias"]}
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(np.ascontiguousarray(tg[name]))
        norms.append(state.apply_gradients()[0].item())
    assert min(norms) > 35.0     # the clip was active
    got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    np.testing.assert_allclose(got["proj.weight"],
                               np.asarray(jp["proj"]["kernel"]).T, rtol=1e-6)
    np.testing.assert_allclose(got["proj.bias"], np.asarray(jp["proj"]["bias"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["norm.weight"],
                               np.asarray(jp["norm"]["scale"]), rtol=1e-6)
    np.testing.assert_allclose(got["norm.bias"], np.asarray(jp["norm"]["bias"]),
                               rtol=1e-6)


def test_conv_module_batch_stats_match_flax():
    """One train-mode forward: output and running statistics as flax's
    `batch_stats` (biased batch variance in both)."""
    from gedepth_tpu.models.layers import ConvModule as JaxConvModule

    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (2, 4, 5, 6)).astype(np.float32)  # n = 40
    jm = JaxConvModule(8, kernel_size=3, use_norm=True, act=jax.nn.relu)
    variables = _random_variables(
        lambda k, a: jm.init(k, a, train=True), jnp.asarray(x), seed=4)
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tm = ConvModule(6, 8, 3, use_norm=True, act=torch.relu).train()
    sd = state_dict_from_flax({"neck": {"lateral0": variables["params"]}},
                              {"neck": {"lateral0": variables["batch_stats"]}})
    tm.load_state_dict({k[len("neck.lateral_convs.0."):]: v
                        for k, v in sd.items()}, strict=True)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


def _identity_dropout(monkeypatch):
    """flax's nn.Dropout as the identity, inside this test only."""
    import flax.linen

    class _Identity:
        def __init__(self, *args, **kwargs):
            pass

        def __call__(self, x, *args, **kwargs):
            return x

    monkeypatch.setattr(flax.linen, "Dropout", _Identity)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


def test_hahi_neck_batch_stats_match_flax(monkeypatch):
    from gedepth_tpu.models.hahi import HAHINeck as JaxHAHINeck
    from gedepth_tpu_torch.models.hahi import HAHINeck

    _identity_dropout(monkeypatch)
    rng = np.random.default_rng(5)
    chans = (16, 24, 32, 40, 48)
    grids = ((16, 32), (8, 16), (4, 8), (2, 4), (1, 2))
    feats = [rng.normal(0.3, 1.0, (2, h_, w_, c)).astype(np.float32)
             for (h_, w_), c in zip(grids, chans)]
    jm = JaxHAHINeck(in_channels=chans, out_channels=chans, embed_dim=32,
                     num_heads=2, num_points=3, sampling="windowed",
                     window_radius=4, hi_min_level=1, msda_remat=False)
    args = [jnp.asarray(f) for f in feats]
    variables = _random_variables(lambda k, x: jm.init(k, x), args, seed=6)
    _, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, args)

    tm = HAHINeck(chans, chans, embed_dim=32, num_heads=2, num_points=3,
                  sampling="windowed", window_radius=4,
                  hi_min_level=1).train()
    _no_dropout(tm)
    sd = state_dict_from_flax({"neck": variables["params"]},
                              {"neck": variables["batch_stats"]})
    tm.load_state_dict({k[len("neck."):]: v for k, v in sd.items()},
                       strict=True)
    tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    want = state_dict_from_flax({}, {"neck": mutated["batch_stats"]})
    got = tm.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key[len("neck."):]].numpy(),
                                       value.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=key)


def test_msdeform_attention_dropout_in_training_only():
    """Dropout 0.1 after the output projection in training, from the given
    generator; nothing in eval mode."""
    from gedepth_tpu_torch.models.hahi import MSDeformAttention

    rng = np.random.default_rng(7)
    levels = ((4, 8), (2, 4))
    query = torch.from_numpy(rng.normal(0, 1, (2, 8, 16)).astype(np.float32))
    value = torch.from_numpy(rng.normal(0, 1, (2, 40, 16)).astype(
        np.float32))
    m = MSDeformAttention(16, 2, 2, 2, 4, sampling="windowed")
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape).astype(
                np.float32)))
        args = (query, value, torch.zeros_like(query), levels, levels[1:])
        projected = m.eval()(*args) - query
        m.train()
        with pytest.raises(RuntimeError):
            m(*args)                     # no generator: no global RNG
        m.dropout.generator = torch.Generator().manual_seed(9)
        got = m(*args) - query
    keep = torch.rand(projected.shape,
                      generator=torch.Generator().manual_seed(9)) < 0.9
    want = torch.where(keep, projected / 0.9, 0.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert 0 < (got == 0).float().mean().item() < 0.3


def _synthetic_batches(steps, H=64, W=128, seed=0):
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(H, W))
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=H, width=W),
                         build_train_pipeline(data), 2, seed=seed)
    return [loader.make_batch(s) for s in range(steps)]


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
            for k in ("img", "depth_gt", "pe_k_gt", "cam_height")}


def test_train_run_reproducible_from_seed():
    """Two CPU runs with DropPath (rate 0.1) and dropout on, from the same
    seeds, give bitwise-equal losses over 3 steps; a train-mode forward
    without a generator raises."""
    _, tcfg = _smoke_model_configs()
    cfg = get_config("smoke_synthetic")
    batches = [_tensors(b) for b in _synthetic_batches(3, 32, 64)]

    def run(seed):
        model = tcfg.build(generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, cfg.optim, 10, seed=seed)
        step = make_train_step()
        return [step(state, b)["loss"].item() for b in batches]

    a, b, c = run(1), run(1), run(2)
    assert a == b
    assert a != c
    model = tcfg.build().train()
    with pytest.raises(RuntimeError):
        model(batches[0]["img"])


def test_train_after_inference_mode():
    """A forward under inference_mode first leaves the cached index and
    anchor tables usable by autograd."""
    _, tcfg = _smoke_model_configs()
    model = tcfg.build()
    batch = _tensors(_synthetic_batches(1, 32, 64)[0])
    with torch.inference_mode():
        model(batch["img"], batch["cam_height"])
    state = create_train_state(model, get_config("smoke_synthetic").optim,
                               10)
    metrics = make_train_step()(state, batch)
    assert np.isfinite(metrics["loss"].item())
    assert all(p.grad is not None for p in model.parameters())


def test_train_steps_match_jax(monkeypatch):
    """Three steps of `make_train_step` on both sides from the same weights
    and batches (smoke widths, the windowed neck with hi_min_level 1,
    64x128, batch 2, drop_path_rate 0, dropout off): per-step losses and
    gradient norm, then BatchNorm statistics and parameters."""
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step

    _identity_dropout(monkeypatch)
    jcfg, tcfg = _smoke_model_configs(drop_path_rate=0.0)
    lr, steps = 1e-6, 3
    batches = _synthetic_batches(steps)
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(batches[0]["img"]),
                                  jnp.asarray(batches[0]["cam_height"]),
                                  seed=8)
    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_train_step(jmodel, donate=False)

    model = tcfg.build()
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    _no_dropout(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(lr, 10, 0),
                       torch.Generator().manual_seed(0))
    tstep = make_train_step()
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        tm = tstep(state, _tensors(batch))
        for key in ("loss", "loss_depth", "loss_slope", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")

    want = state_dict_from_flax(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(want) == set(got)
    moved = differ = total = 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=0, atol=2 * lr * steps, err_msg=key)
        d_jax = (value - before[key]).numpy()
        d_port = (got[key] - before[key]).numpy()
        moved += int((np.abs(d_jax) > lr / 2).sum())
        differ += int((np.abs(d_port - d_jax) > lr / 2).sum())
        total += d_jax.size
    assert moved > 0.5 * total          # the updates are not trivial
    assert differ < 1e-3 * total        # sign flips only


def test_stochastic_layers_share_one_base():
    """Every random layer of the model is one `set_generator` reaches."""
    _, tcfg = _smoke_model_configs()
    model = tcfg.build()
    layers = [m for m in model.modules() if isinstance(m, Stochastic)]
    assert len(layers) == sum(tcfg.depths) + 2     # DropPath + 2 dropouts
    g = torch.Generator()
    model.set_generator(g)
    assert all(m.generator is g for m in layers)
