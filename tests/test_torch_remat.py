"""Remat and the train step's last arguments in the PyTorch port, on the CPU.

`swin_remat`: two train steps at smoke width with DropPath (rate 0.3) and
dropout on, in f32 and in `bf16_compute`, with remat and without, from the same weights, generator and
batches: the losses and every gradient equal to the bit, the generator's
state equal after each step, and window attention called twice a block a
step with remat (forward and recompute) against once without. One step
against the JAX package's gradients (`swin_remat=True` there, as by
default; DropPath 0 and dropout off, since the two frameworks draw other
masks): the loss rtol 1e-4, each parameter's gradient within 1e-4 of its
norm in L2, ‖g − g_jax‖ <= 1e-4·‖g_jax‖ + 1e-6 (elementwise, gradients
within rounding of zero differ in sign between frameworks; the absolute
term covers `backbone.norm{i}.bias`, which feed only a conv and a
train-mode BatchNorm that takes a constant shift out again, so both sides
hold rounding noise of ~5e-8 there; the other tensors agree to ~3e-5).
Evaluation and the exported program never reach the checkpoint.

The tables a module makes itself (Swin's relative-position bias, the
HAHI and BinsFormer level embeds, the DPT deconv, AdaBins' attention and
positional table, BinsFormer's queries) start as zeros, never as
uninitialised memory: a fresh module is finite before its initialisation,
and a seeded model is what it was when they were `torch.empty`.

`neck_msda_remat`: the `msda` op saves its three inputs (value, pos,
weights) and nothing else for the backward on every sampling rule, with
the switch on or off, and the two settings give the same numbers.

`sigloss(valid, max_depth)`, `make_train_step(sig_max_depth)` and
`HAHINeck(self_att, cross_att, pos_num_feats)` against the JAX package on
the same inputs and bridged weights: the loss rtol 1e-5 (its gradient too),
the train step's losses rtol 1e-4, the neck's outputs rtol 1e-4 atol 1e-5,
and the neck's parameter tree equal to the JAX tree for every combination
of its flags.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.models import losses as jlosses
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax
from gedepth_tpu_torch.models import losses as tlosses
from gedepth_tpu_torch.models import swin as tswin
from gedepth_tpu_torch.ops import msda as msda_ops
from gedepth_tpu_torch.ops import window_attention as wa
from gedepth_tpu_torch.train.steps import create_train_state, make_train_step

from test_torch_gedepth import _random_variables
from test_torch_train import (
    _depth_batch, _identity_dropout, _no_dropout, _smoke_model_configs,
    _synthetic_batches, _tensors)

torch.set_num_threads(1)


def _run_steps(tcfg, batches, remat, monkeypatch, bf16=False):
    """Two train steps of a fresh smoke model: (losses, gradients per step,
    generator state after each step, window-attention calls per step)."""
    model = dataclasses.replace(tcfg, swin_remat=remat).build(
        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, get_config("smoke_synthetic").optim,
                               10, seed=1)
    step = make_train_step(bf16=bf16)
    calls = []
    real = wa.window_attention

    def counted(*args):
        calls[-1] += 1
        return real(*args)

    monkeypatch.setattr(wa, "window_attention", counted)
    out = []
    for batch in batches:
        calls.append(0)
        metrics = step(state, batch)
        out.append((metrics["loss"].item(),
                    {n: p.grad.clone() for n, p in model.named_parameters()},
                    state.generator.get_state()))
    monkeypatch.setattr(wa, "window_attention", real)
    return out, calls


@pytest.mark.parametrize("bf16", [False, True])
def test_swin_remat_equals_no_remat(bf16, monkeypatch):
    """f32, and `bf16_compute`, whose step calls the model on bf16 copies
    of the weights (`torch.func.functional_call`): the recompute must run
    on those copies too."""
    _, tcfg = _smoke_model_configs(drop_path_rate=0.3)
    batches = [_tensors(b) for b in _synthetic_batches(2, 32, 64)]
    with_remat, calls_remat = _run_steps(tcfg, batches, True, monkeypatch,
                                         bf16)
    without, calls_plain = _run_steps(tcfg, batches, False, monkeypatch,
                                      bf16)
    blocks = sum(tcfg.depths)
    assert calls_plain == [blocks] * 2
    assert calls_remat == [2 * blocks] * 2
    for i, ((la, ga, sa), (lb, gb, sb)) in enumerate(zip(with_remat,
                                                         without)):
        assert la == lb, (i, la, lb)
        assert torch.equal(sa, sb), f"generator state after step {i}"
        assert set(ga) == set(gb)
        for name in ga:
            assert torch.equal(ga[name], gb[name]), (i, name)
    # DropPath drew: the generator moved and the masks mattered
    assert not torch.equal(with_remat[0][2], with_remat[1][2])


def test_remat_draws_replayed_not_advanced():
    """A block under `remat_block` with DropPath: its backward leaves the
    generator where the forward left it, and the gradient is that of the
    forward's masks."""
    from gedepth_tpu_torch.models.layers import init_weights

    torch.manual_seed(0)
    block = tswin.SwinBlock(16, 2, 2, shift=True, drop_path=0.5).train()
    init_weights(block, torch.Generator().manual_seed(4))
    x = torch.randn(4, 16, 16, requires_grad=True)
    gen = torch.Generator().manual_seed(3)
    block.drop_path.generator = gen
    start = gen.get_state()
    want = block(x, (4, 4))
    want.sum().backward()
    want_grad, after = x.grad.clone(), gen.get_state()
    x.grad = None
    gen.set_state(start)
    got = tswin.remat_block(block, x, (4, 4))
    assert torch.equal(gen.get_state(), after)
    got.sum().backward()
    assert torch.equal(gen.get_state(), after)
    assert torch.equal(got, want)
    assert torch.equal(x.grad, want_grad)


def _fresh_modules():
    """Every module of the port that makes a parameter of its own (not an
    nn.Linear's, nn.Conv2d's or a norm's), constructed without `init_weights`
    or `init_params`: (name, module)."""
    from gedepth_tpu_torch.models import adabins, binsformer, dpt, hahi

    chans = (8, 8, 16, 32, 64)
    return [
        ("SwinBlock", tswin.SwinBlock(16, 2, 7, shift=True)),
        ("WindowMSA", tswin.WindowMSA(16, 2, 7)),
        ("HAHINeck", hahi.HAHINeck(chans, chans, 16, num_heads=2,
                                   num_points=2)),
        ("Deconv", dpt.Deconv(8, 4, 4)),
        ("MultiheadAttention", adabins.MultiheadAttention(16, 4)),
        ("PatchTransformerEncoder", adabins.PatchTransformerEncoder(16)),
        ("BinsFormerHead", binsformer.BinsFormerHead(
            chans, conv_dim=16, n_bins=8, num_encoder_layers=1,
            num_decoder_layers=1)),
        ("binsformer._EncoderLayer", binsformer._EncoderLayer(16, 8, 3, 32,
                                                              2)),
        ("binsformer._DecoderLayer", binsformer._DecoderLayer(16, 8, 32)),
    ]


def _non_finite(modules):
    return [f"{name}.{k}" for name, m in modules
            for k, t in m.state_dict().items()
            if t.is_floating_point() and not torch.isfinite(t).all()]


def test_fresh_modules_hold_no_uninitialised_memory(monkeypatch):
    """A module's parameters and buffers are finite before any
    initialisation: first after large and small blocks filled with NaN
    were freed (the allocator may hand them back), then with `torch.empty`
    itself returning NaN while the modules are built (torch's own layers
    fill what they take from it in their constructors)."""
    for n in (1 << 22, 1 << 18, 1 << 14, 1 << 12, 1 << 10, 1 << 8):
        blocks = [torch.full((n,), float("nan")) for _ in range(16)]
        del blocks
    assert _non_finite(_fresh_modules()) == []

    real_empty = torch.empty

    def nan_empty(*args, **kwargs):
        return real_empty(*args, **kwargs).fill_(float("nan"))

    monkeypatch.setattr(torch, "empty", nan_empty)
    assert _non_finite(_fresh_modules()) == []


# sha256 over the sorted (key, bytes) of each model's state_dict, built from
# seed 0, as the port built them while its tables were made by torch.empty:
# the zeros that replaced it are all overwritten by the initialisation
SEEDED_DIGESTS = {
    "smoke_synthetic": (
        {}, "06d26a0033867cebe48002fb0febd03aeeaa2575bddc841292ed31ea641f0139"),
    "bts_kitti": (
        dict(backbone_variant="18", head_channels=32),
        "972cc44fd32ef84c60a62be883516ec0b18d7275ffa5f04e1ec5ef861ee29a50"),
    "densedepth_kitti": (
        dict(backbone_variant="18", head_channels=16),
        "76c2794ce2089951b472053c76b773f973674ef382e18d044f30d8a4b607ed99"),
    "dpt_kitti": (
        dict(head_channels=16, backbone_embed_dims=32, backbone_depth=4),
        "3ff460795e1f4d18d179dfaa01b0a7560880b01a7431d030b4fb43b5ea00bf1d"),
    "adabins_nyu": (
        dict(head_channels=8, n_bins=16),
        "9b188c9fe467c2b3e8867af154ec31b90acf4935a7591f2f8276858a45e1ea12"),
}


@pytest.mark.parametrize("name", sorted(SEEDED_DIGESTS))
def test_seeded_models_unchanged_by_the_zero_tables(name):
    """A GEDepth and each zoo model built from seed 0 have the state_dict
    they had before their tables were made with zeros (the digests above),
    and the same when every parameter and buffer is NaN before the seeded
    initialisation runs again."""
    import hashlib

    from gedepth_tpu_torch.models.layers import init_weights

    over, digest = SEEDED_DIGESTS[name]
    cfg = dataclasses.replace(get_config(name).model, **over)
    model = cfg.build(generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == digest
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    init_weights(model, torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _jax_grads(jmodel, variables, batch):
    """Loss and gradients of the JAX train step's loss (`make_train_step`'s
    loss_fn, train=True, no dropout RNG needed at rate 0)."""
    from gedepth_tpu.ops.resize import resize_bilinear

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch["img"], batch["cam_height"], True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        gt = batch["depth_gt"][..., None]
        depth = resize_bilinear(out["depth"], gt.shape[1:3],
                                align_corners=True)
        return (jlosses.sigloss(depth, gt) + 0.08 * jlosses.softmax_ce_ignore(
            out["slope_logits"], batch["pe_k_gt"]))

    return jax.jit(jax.value_and_grad(loss_fn))(variables["params"])


def test_swin_remat_gradients_match_jax(monkeypatch):
    _identity_dropout(monkeypatch)
    jcfg, tcfg = _smoke_model_configs(drop_path_rate=0.0)
    assert jcfg.swin_remat and tcfg.swin_remat
    batch = _synthetic_batches(1, 32, 64)[0]
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(batch["img"]),
                                  jnp.asarray(batch["cam_height"]), seed=8)
    loss, grads = _jax_grads(jmodel, variables,
                             {k: jnp.asarray(v) for k, v in batch.items()})

    model = tcfg.build()
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    _no_dropout(model)
    # no clipping: the gradients stay as the backward left them
    optim = dataclasses.replace(get_config("smoke_synthetic").optim,
                                grad_clip_norm=1e30)
    state = create_train_state(model, optim, 10)
    metrics = make_train_step()(state, _tensors(batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss),
                               rtol=1e-4)
    want = state_dict_from_flax(jax.device_get(grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) - {k for k in want if k.endswith("tracked")} == set(got)
    ratios = {}
    for name, g in got.items():
        ref = want[name]
        err = float((g - ref).norm())
        assert err <= 1e-4 * float(ref.norm()) + 1e-6, (name, err,
                                                        float(ref.norm()))
        ratios[name] = (err / max(float(ref.norm()), 1e-30),
                        float(ref.norm()))
    for name, r in sorted(ratios.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"{name}: relative L2 difference {r[0]:.3e} of norm {r[1]:.3e}")


def test_eval_and_export_never_reach_the_checkpoint(monkeypatch):
    """Remat acts in training only: an eval forward with remat equals one
    without, to the bit, and neither it nor the export of the eval step
    calls `torch.utils.checkpoint`."""
    from gedepth_tpu_torch.apis.export import export_depther

    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint outside training")

    monkeypatch.setattr(tswin, "checkpoint", refuse)
    _, tcfg = _smoke_model_configs()
    img = _tensors(_synthetic_batches(1, 32, 64)[0])["img"][:1]
    outs = []
    for remat in (True, False):
        model = dataclasses.replace(tcfg, swin_remat=remat).build()
        with torch.no_grad():
            outs.append(model(img)["depth"])
    assert torch.equal(*outs)
    cfg = get_config("smoke_synthetic")
    assert cfg.model.swin_remat
    exported, _, _ = export_depther(cfg, hw=(32, 64), device="cpu")
    # flip-TTA: each block's window attention twice a request, as before
    calls = [n for n in exported.graph.nodes
             if getattr(n.target, "namespace", None) == "gedepth_torch"
             and n.target.name() == "gedepth_torch::window_attention"]
    assert len(calls) == 2 * sum(cfg.model.depths)


def _msda_inputs(mode, seed=0):
    from gedepth_tpu_torch.models.hahi import MSDeformAttention

    rng = np.random.default_rng(seed)
    levels = ((8, 16), (4, 8), (2, 4), (1, 2))
    S = sum(h * w for h, w in levels)
    C = 16

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    query, value = t(2, S, C), t(2, S, C)
    qpos = t(1, S, C)
    ref = msda_ops.center_reference_points(levels, torch.device("cpu"))
    modules = []
    for flag in (True, False):
        m = MSDeformAttention(C, 2, 4, 3, window_radius=2, sampling=mode,
                              msda_remat=flag)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(np.random.default_rng(seed + 1)
                                         .normal(0, 0.3, p.shape)
                                         .astype(np.float32)))
        modules.append(m.eval())
    return modules, (query, value, qpos, levels, levels,
                     None if mode == "windowed" else ref)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "windowed",
                                  "windowed_compat"])
def test_msda_op_saves_only_its_inputs(mode, monkeypatch):
    modules, args = _msda_inputs(mode)
    real = msda_ops.msda
    seen = []

    def watched(value, spatial_shapes, pos, weights, *rest):
        packed = []

        def pack(t):
            packed.append(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real(value, spatial_shapes, pos, weights, *rest)
        key = [(t.data_ptr(), tuple(t.shape), t.stride()) for t in packed]
        seen.append((key, [(t.data_ptr(), tuple(t.shape), t.stride())
                           for t in (value, pos, weights)],
                     sum(t.numel() * t.element_size() for t in packed)))
        return out

    monkeypatch.setattr(msda_ops, "msda", watched)
    results = []
    for m in modules:
        assert m.msda_remat is (m is modules[0])
        query, value, *rest = args
        query = query.clone().requires_grad_()
        value = value.clone().requires_grad_()
        out = m(query, value, *rest)
        out.square().sum().backward()
        results.append([out.detach(), query.grad, value.grad]
                       + [p.grad for p in m.parameters()])
    assert len(seen) == 2
    for saved, inputs, nbytes in seen:
        assert saved == inputs, (mode, saved, inputs)
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("max_depth", [None, 40.0])
def test_sigloss_valid_and_max_depth_match_jax(valid, max_depth):
    rng = np.random.default_rng(1)
    pred, gt = _depth_batch(rng)
    mask = (rng.random(gt.shape) < 0.7).astype(np.float32) if valid else None
    jvalid = None if mask is None else jnp.asarray(mask)
    want, want_grad = jax.value_and_grad(lambda p: jlosses.sigloss(
        p, jnp.asarray(gt), valid=jvalid, max_depth=max_depth))(
            jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tlosses.sigloss(p, torch.from_numpy(gt),
                          valid=None if mask is None
                          else torch.from_numpy(mask),
                          max_depth=max_depth)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-9)
    if valid or max_depth is not None:
        assert got.item() != tlosses.sigloss(
            p.detach(), torch.from_numpy(gt)).item()


def test_train_step_sig_max_depth_matches_jax(monkeypatch):
    """One step of both packages' `make_train_step` with sig_max_depth the
    median of the batch's ground truth."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState

    _identity_dropout(monkeypatch)
    jcfg, tcfg = _smoke_model_configs(drop_path_rate=0.0)
    batch = _synthetic_batches(1, 32, 64)[0]
    gt = batch["depth_gt"]
    cut = float(np.median(gt[gt > 0]))          # half the pixels past it
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(batch["img"]),
                                  jnp.asarray(batch["cam_height"]), seed=8)
    tx, _ = joptim.make_optimizer(1e-6, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    _, jm = jax_train_step(jmodel, sig_max_depth=cut, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    model = tcfg.build()
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    _no_dropout(model)
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(1e-6, 10, 0),
                       torch.Generator().manual_seed(0))
    tm = make_train_step(sig_max_depth=cut)(state, _tensors(batch))
    for key in ("loss", "loss_depth", "grad_norm"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("sampling", ["windowed", "bilinear"])
@pytest.mark.parametrize("self_att,cross_att",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_hahi_neck_flags_match_jax(sampling, self_att, cross_att):
    from gedepth_tpu.models.hahi import HAHINeck as JaxHAHINeck
    from gedepth_tpu_torch.models.hahi import HAHINeck

    rng = np.random.default_rng(5)
    chans = (16, 24, 32, 40, 48)
    grids = ((16, 32), (8, 16), (4, 8), (2, 4), (1, 2))
    feats = [rng.normal(0.3, 1.0, (2, h_, w_, c)).astype(np.float32)
             for (h_, w_), c in zip(grids, chans)]
    # the encoding's width spelled out on one side of each pair
    pos_feats = 16 if sampling == "bilinear" else 0
    jm = JaxHAHINeck(in_channels=chans, out_channels=chans, embed_dim=32,
                     num_heads=2, num_points=3, sampling=sampling,
                     window_radius=4, self_att=self_att, cross_att=cross_att,
                     pos_num_feats=pos_feats)
    args = [jnp.asarray(f) for f in feats]
    variables = _random_variables(lambda k, x: jm.init(k, x), args, seed=6)
    want = jax.jit(lambda v, x: jm.apply(v, x))(variables, args)

    tm = HAHINeck(chans, chans, embed_dim=32, num_heads=2, num_points=3,
                  sampling=sampling, window_radius=4, self_att=self_att,
                  cross_att=cross_att, pos_num_feats=16 - pos_feats).eval()
    assert (tm.self_attn is None) is not self_att
    assert (tm.multi_att is None) is not cross_att
    sd = state_dict_from_flax({"neck": variables["params"]},
                              {"neck": variables["batch_stats"]})
    sd = {k[len("neck."):]: v for k, v in sd.items()}
    own = tm.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-5)
