"""The PyTorch port's bf16 paths against the JAX package, on the CPU.

The four `bf16_scope`s with `cast_params_bf16`, whole-model bf16 evaluation
(`make_eval_step`, `make_slide_eval_step`, `Evaluator`, `tools.test --bf16`),
bf16-compute training (`make_train_step(bf16=True)`), the parity preset, the
plain versions of the three ops on bf16 tensors, the timing CLI, and the
constructors' defaults. On the CPU the port runs its plain versions; the JAX
side runs its XLA paths.

Tolerances. LayerNorm, softmax and GELU in bf16 round at other places in
XLA on the CPU than in PyTorch, so the two bf16 sides are not compared bit
for bit: each is held to its own f32 result, and to the other by its mean
relative difference.
  * a plain version on bf16 inputs against float64 of the same inputs:
    within 1 bf16 ulp of the output's largest magnitude (f32 inside, one
    rounding out); against the JAX function on the same bf16 inputs: mean
    relative difference < 2e-2;
  * a scoped model: outputs f32; mean relative depth error against the
    port's own f32 forward < 0.02 (the JAX package's own bound) and at most
    twice the JAX package's error against its f32 forward on the same
    weights (which, on these seeded weights, is itself up to 0.03 where the
    head is inside the scope);
  * eval steps: mean relative difference to f32 < 0.02;
  * 8 bf16-compute train steps: losses within rtol 0.05 of the port's f32
    run and of the JAX package's bf16 run.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.apis.inference import cast_params_bf16 as jax_cast
from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.apis import cast_params_bf16, init_depther
from gedepth_tpu_torch.apis.inference import SCOPE_MODULES
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import load_flax_variables
from gedepth_tpu_torch.convert.from_jax import (
    _flatten, _torch_name, unstack_swin_params)
from gedepth_tpu_torch.models import layers
from gedepth_tpu_torch.ops import msda as msda_ops
from gedepth_tpu_torch.ops import pe_fusion as pe_ops
from gedepth_tpu_torch.ops import window_attention as wa
from gedepth_tpu_torch.train.steps import (
    TrainState, make_eval_step, make_slide_eval_step, make_train_step)
from gedepth_tpu_torch.train import optim as toptim

from test_torch_gedepth import _random_variables, _sample

torch.set_num_threads(1)

BF16 = torch.bfloat16
H, W = 64, 128
SCOPES = ("backbone", "backbone_neck", "backbone_head", "backbone_neck_head")


def _ulp(x):
    """One bf16 unit in the last place at magnitude x."""
    return 2.0 ** (int(np.floor(np.log2(max(float(x), 1e-30)))) - 7)


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _mean_rel(got, want, floor=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean(np.abs(got - want) / np.maximum(np.abs(want),
                                                         floor)))


def _assert_one_ulp(got, ref):
    assert got.dtype == BF16
    err = (got.double() - ref).abs().max().item()
    assert err <= _ulp(ref.abs().max().item()), err


# ---- the plain versions on bf16 tensors ------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_plain_bf16(masked):
    from gedepth_tpu.ops.window_attention import window_attention_xla
    from gedepth_tpu_torch.models.swin import shifted_window_mask

    rng = np.random.default_rng(0)
    nWB, N, heads, D = 8, 49, 2, 16
    (q, jq), (k, jk), (v, jv) = (
        _bf16(rng.standard_normal((nWB, N, heads, D)) * s)
        for s in (D ** -0.5, 1.0, 1.0))
    bias, jbias = _bf16(rng.normal(0, 0.5, (heads, N, N)))
    mask = jmask = None
    if masked:
        m = shifted_window_mask(14, 28, 7, 3)
        mask, jmask = torch.from_numpy(m), jnp.asarray(m)
    got = wa.window_attention(q, k, v, bias, mask)
    ref = wa.window_attention_plain(
        q.double(), k.double(), v.double(), bias.double(),
        None if mask is None else mask.double())
    _assert_one_ulp(got, ref)
    want = window_attention_xla(jq, jk, jv, jbias, jmask)
    assert want.dtype == jnp.bfloat16
    assert _mean_rel(got.float().numpy(),
                     np.asarray(want.astype(jnp.float32))) < 2e-2


@pytest.mark.parametrize("rule", ["windowed", "compat", "exact"])
def test_msda_plain_bf16(rule):
    from gedepth_tpu.models import hahi as jhahi
    from gedepth_tpu.ops.msda import msda_sample, msda_sample_windowed
    from test_torch_sampling_modes import _jax_locations, _rule_inputs

    rng = np.random.default_rng(1)
    levels, query_hw, R = ((8, 16), (4, 8), (2, 4)), (8, 16), 4
    B, h, d = 2, 2, 8
    values = [rng.standard_normal((B, H_, W_, h, d)).astype(np.float32)
              for (H_, W_) in levels]
    pairs = [_bf16(v) for v in values]
    value = torch.cat([t.reshape(B, -1, h, d) for t, _ in pairs], dim=1)
    jvalues = [j for _, j in pairs]
    ref, off, w = _rule_inputs(rng, (query_hw,), levels, learned=True)
    ref_t, off_t, w_t = (torch.from_numpy(a) for a in (ref, off, w))
    if rule == "windowed":
        pos = msda_ops.windowed_positions(off_t, (query_hw,), levels, R)
        want = msda_sample_windowed(
            jvalues, R * jnp.tanh(jnp.asarray(off) / R), jnp.asarray(w),
            query_hw, radius=R, remat=False, impl="tiled",
            precision=jax.lax.Precision.HIGHEST)
    elif rule == "compat":
        pos, _ = msda_ops.compat_positions(ref_t, off_t, (query_hw,), levels,
                                           R)
        delta = jhahi.compat_delta_px(jnp.asarray(ref), jnp.asarray(off),
                                      (query_hw,), levels)
        want = msda_sample_windowed(
            jvalues, jnp.clip(delta, -float(R), float(R)), jnp.asarray(w),
            query_hw, radius=R, remat=False, impl="tiled",
            precision=jax.lax.Precision.HIGHEST)
    else:
        pos = msda_ops.exact_positions(ref_t, off_t, levels)
        want = msda_sample(jvalues, _jax_locations(ref, off, levels),
                           jnp.asarray(w), remat=False, sampling="bilinear",
                           impl="per_level")
    assert pos.dtype == torch.float32
    got = msda_ops.msda(value, levels, pos, w_t)
    f64 = msda_ops.msda_plain(value.double(), levels, pos.double(),
                              w_t.double())
    _assert_one_ulp(got, f64)
    assert _mean_rel(got.float().numpy(),
                     np.asarray(want.astype(jnp.float32)), 1e-1) < 2e-2


def test_pe_fusion_plain_bf16():
    from gedepth_tpu.ops.pallas.pe_fusion import pe_fusion_xla

    rng = np.random.default_rng(2)
    logits, jlogits = _bf16(rng.normal(0, 1, (2, 16, 24, 11)))
    pe, jpe = _bf16(rng.uniform(2, 80, (2, 16, 24)))
    y, jy = _bf16(rng.uniform(0, 1, (2, 16, 24)))
    cam, jcam = _bf16(np.asarray([1.65, 1.5]))
    got = pe_ops.pe_fusion(logits, pe, y, cam, 200.0)
    ref = pe_ops.pe_fusion_plain(logits.double(), pe.double(), y.double(),
                                 cam.double(), 200.0)
    _assert_one_ulp(got, ref)
    want = pe_fusion_xla(jlogits, jpe, jy, jcam, 200.0)
    assert _mean_rel(got.float().numpy(),
                     np.asarray(want.astype(jnp.float32)), 1e-1) < 2e-2


def test_function_wiring_bf16(monkeypatch):
    """`MSDAFunction` and `WindowAttentionFunction` on bf16 tensors, their
    launches swapped for the plain versions: every gradient comes back in
    its input's dtype (bf16 value, q, k, v and bias; f32 pos and weights)."""
    monkeypatch.setattr(
        msda_ops, "_launch_forward",
        lambda value, shapes, pos, weights, window:
        msda_ops.msda_plain(value, shapes, pos, weights))
    monkeypatch.setattr(
        msda_ops, "msda_backward",
        lambda value, shapes, pos, weights, grad_out, *window:
        msda_ops.msda_backward_plain(value, shapes, pos, weights, grad_out))
    monkeypatch.setattr(wa, "_launch_forward", wa.window_attention_plain)
    rng = np.random.default_rng(3)
    levels, grids = ((4, 8), (2, 4)), ((4, 8),)
    value = torch.from_numpy(rng.standard_normal((1, 40, 2, 8)).astype(
        np.float32)).to(BF16).requires_grad_()
    pos = msda_ops.windowed_positions(torch.from_numpy(rng.normal(
        0, 2, (1, 32, 2, 2, 3, 2)).astype(np.float32)), grids, levels, 4)
    pos = pos.requires_grad_()
    w = torch.rand(1, 32, 2, 2, 3).requires_grad_()
    out = msda_ops.MSDAFunction.apply(value, levels, pos, w, (grids, 4.0))
    assert out.dtype == BF16
    out.float().square().sum().backward()
    assert (value.grad.dtype, pos.grad.dtype, w.grad.dtype) == (
        BF16, torch.float32, torch.float32)
    assert value.grad.abs().sum() > 0 and pos.grad.abs().sum() > 0
    want = msda_ops.msda_backward_plain(
        value.detach().float(), levels, pos.detach(), w.detach(),
        (2 * out.detach().float()).to(BF16).float())
    torch.testing.assert_close(pos.grad, want[1], rtol=1e-5, atol=1e-6)

    q, k, v = (torch.randn(4, 9, 2, 8).to(BF16).requires_grad_()
               for _ in range(3))
    bias = torch.randn(2, 9, 9).to(BF16).requires_grad_()
    out = wa.WindowAttentionFunction.apply(q, k, v, bias, None)
    assert out.dtype == BF16
    out.float().sum().backward()
    assert {t.grad.dtype for t in (q, k, v, bias)} == {BF16}


# ---- dtype hygiene of the layers -------------------------------------

def test_layers_keep_bf16():
    """A bf16 module on a bf16 input returns bf16: DropPath and Dropout
    divide in f32 and return the input's dtype; a train-mode BatchNorm takes
    f32 statistics of a bf16 activation into f32 or bf16 buffers; the sine
    encoding is f32 and the neck casts it to its query's dtype."""
    x = torch.randn(4, 6, 5, 5).to(BF16)
    for cls in (layers.DropPath, layers.Dropout):
        m = cls(0.5).train()
        m.generator = torch.Generator().manual_seed(0)
        y = m(x)
        assert y.dtype == BF16
        kept = y[y != 0].float()
        torch.testing.assert_close(kept, (x[y != 0].float() / 0.5).to(
            BF16).float())
    assert layers.sine_positional_encoding(3, 4, 8).dtype == torch.float32
    for stats in (torch.float32, BF16):
        bn = layers.BatchNorm2d(6).train()
        bn.weight.data = bn.weight.data.to(BF16)
        bn.bias.data = bn.bias.data.to(BF16)
        bn.running_mean.data = bn.running_mean.data.to(stats)
        bn.running_var.data = bn.running_var.data.to(stats)
        assert bn(x).dtype == BF16
        assert bn.running_mean.dtype == stats
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        torch.testing.assert_close(bn.running_mean.float(), 0.1 * mean,
                                   rtol=1e-2, atol=1e-3)
        torch.testing.assert_close(bn.running_var.float(),
                                   0.9 + 0.1 * var, rtol=1e-2, atol=1e-3)


# ---- the scopes ------------------------------------------------------

SCOPE_SAMPLING = {"backbone": "windowed", "backbone_neck": "windowed",
                  "backbone_head": "windowed_compat",
                  "backbone_neck_head": "bilinear"}


def _model_configs(**over):
    return (dataclasses.replace(jax_get_config("smoke_synthetic").model,
                                **over),
            dataclasses.replace(get_config("smoke_synthetic").model, **over))


def _jax_dtypes(variables):
    """torch key -> dtype name of the matching leaf of a flax tree."""
    params = dict(variables["params"])
    params["backbone"] = unstack_swin_params(params["backbone"])
    leaves = list(_flatten(params)) + list(_flatten(variables["batch_stats"]))
    return {_torch_name(names): str(arr.dtype) for names, arr in leaves}


@pytest.mark.parametrize("scope", SCOPES)
def test_gedepth_scopes_match_jax(scope):
    over = dict(neck_sampling=SCOPE_SAMPLING[scope], neck_window_radius=4)
    jcfg, tcfg = _model_configs(**over)
    img = _sample(np.random.default_rng(0), H, W)
    cam = np.asarray([1.6], np.float32)
    jimg, jcam = jnp.asarray(img), jnp.asarray(cam)
    jf32 = jcfg.build()
    variables = _random_variables(jf32.init, jimg, jcam, seed=1)
    jref = np.asarray(jax.jit(jf32.apply)(variables, jimg, jcam)["depth"])
    jmixed = dataclasses.replace(jcfg, bf16_scope=scope).build()
    jcast = jax_cast(jax.tree.map(jnp.asarray, variables), scope=scope)
    jout = jax.jit(jmixed.apply)(jcast, jimg, jcam)
    jerr = _mean_rel(np.asarray(jout["depth"]), jref)

    timg, tcam = torch.from_numpy(img), torch.from_numpy(cam)
    f32 = load_flax_variables(tcfg.build(), variables["params"],
                              variables["batch_stats"])
    mixed = load_flax_variables(
        dataclasses.replace(tcfg, bf16_scope=scope).build(),
        variables["params"], variables["batch_stats"])
    keys = list(mixed.state_dict())
    assert cast_params_bf16(mixed, scope) is mixed
    assert list(mixed.state_dict()) == keys            # checkpoint layout
    # every tensor's dtype after the cast, against the JAX tree's
    want_dtypes = _jax_dtypes(jcast)
    for key, t in mixed.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert t.dtype == torch.int64
            continue
        assert str(t.dtype) == "torch." + want_dtypes[key], key
        inside = key.split(".")[0] in SCOPE_MODULES[scope]
        assert t.dtype == (BF16 if inside else torch.float32), key
    with torch.inference_mode():
        ref = f32(timg, tcam)["depth"].numpy()
        out = mixed(timg, tcam)
    for key in ("depth", "y", "slope_logits", "pe_mask"):
        assert out[key].dtype == torch.float32, key
        assert str(jout[key].dtype) == "float32", key
    err = _mean_rel(out["depth"].numpy(), ref)
    assert err < 0.02, (err, jerr)
    assert err <= 2 * jerr, (err, jerr)


def test_cast_params_bf16_all_and_unknown_scope():
    model = get_config("smoke_synthetic").model.build()
    with pytest.raises(ValueError, match="scope"):
        cast_params_bf16(model, "neck")
    keys = list(model.state_dict())
    cast_params_bf16(model, "all")
    assert list(model.state_dict()) == keys
    for key, t in model.state_dict().items():
        assert t.dtype == (BF16 if t.is_floating_point() else torch.int64)
    x = torch.from_numpy(_sample(np.random.default_rng(1), H, W)).to(BF16)
    with torch.inference_mode():
        out = model(x, torch.ones(1))
    # a model cast as a whole follows its input through in bf16
    assert {out[k].dtype for k in out} == {BF16}


def test_bf16_flax_tree_loads():
    """A flax tree already in bf16 loads: its values are lifted exactly,
    then take the dtype of the model's own tensors."""
    jcfg, tcfg = _model_configs(neck_sampling="windowed")
    img = jnp.zeros((1, H, W, 5))
    variables = _random_variables(jcfg.build().init, img, jnp.ones((1,)),
                                  seed=2)
    cast = jax_cast(jax.tree.map(jnp.asarray, variables), scope="all")
    a = load_flax_variables(tcfg.build(), cast["params"],
                            cast["batch_stats"])
    b = cast_params_bf16(load_flax_variables(
        tcfg.build(), variables["params"], variables["batch_stats"]), "all")
    for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype in (torch.float32, torch.int64), key
        assert torch.equal(x.to(y.dtype), y), key


# ---- the parity preset and init_depther ------------------------------

def test_parity_preset_and_init_depther_cast_the_scope():
    cfg = get_config("gedepth_adaptive_kitti_parity")
    assert (cfg.model.neck_sampling, cfg.model.neck_window_radius,
            cfg.model.bf16_scope) == ("windowed_compat", 5, "backbone_head")
    smoke = get_config("smoke_synthetic")
    smoke = smoke.replace(model=dataclasses.replace(
        smoke.model, neck_sampling="windowed_compat", neck_window_radius=5,
        bf16_scope="backbone_head"))
    handle = init_depther(smoke, device="cpu")
    dtypes = {name: {p.dtype for p in getattr(handle.model, name).parameters()}
              for name in ("backbone", "neck", "pe_mask_neck",
                           "dynamic_pe_neck", "decode_head")}
    assert dtypes == {"backbone": {BF16}, "neck": {torch.float32},
                      "pe_mask_neck": {torch.float32},
                      "dynamic_pe_neck": {torch.float32},
                      "decode_head": {BF16}}
    assert handle.model.backbone.bn1.running_var.dtype == BF16
    whole = init_depther("smoke_synthetic", device="cpu", bf16=True)
    assert all(p.dtype == BF16 for p in whole.model.parameters())
    img = _sample(np.random.default_rng(3), 96, 192)
    x, cam = torch.from_numpy(img), torch.ones(1)
    for h in (handle, whole):
        depth = h.eval_step(x, cam)
        assert depth.dtype == torch.float32 and depth.shape == (1, 96, 192)
        assert bool(torch.isfinite(depth).all())


# ---- bf16 evaluation -------------------------------------------------

@pytest.fixture(scope="module")
def eval_models():
    """(f32 model, the same weights cast as a whole, input, cam)."""
    jcfg, tcfg = _model_configs(neck_sampling="windowed",
                                neck_hi_min_level=1)
    img = _sample(np.random.default_rng(4), H, W)
    cam = np.asarray([1.6], np.float32)
    variables = _random_variables(jcfg.build().init, jnp.asarray(img),
                                  jnp.asarray(cam), seed=5)
    f32 = load_flax_variables(tcfg.build(), variables["params"],
                              variables["batch_stats"])
    bf16 = cast_params_bf16(load_flax_variables(
        tcfg.build(), variables["params"], variables["batch_stats"]), "all")
    return f32, bf16, torch.from_numpy(img), torch.from_numpy(cam)


@pytest.mark.parametrize("kind", ["flip", "ratio", "slide"])
def test_eval_steps_bf16(eval_models, kind):
    f32, bf16, img, cam = eval_models

    def step(model, flag):
        if kind == "slide":
            return make_slide_eval_step(model, (64, 64), (32, 32),
                                        flip_tta=True, bf16=flag)
        return make_eval_step(model, flip_tta=kind == "flip",
                              ratio=1.0 if kind == "flip" else 1.5,
                              bf16=flag)

    want = step(f32, False)(img, cam)
    got = step(bf16, True)(img, cam)
    assert got.dtype == torch.float32 and got.shape == (1, H, W)
    assert got.min().item() >= f32.min_depth - 1e-6
    assert got.max().item() <= f32.max_depth + 1e-4
    assert _mean_rel(got.numpy(), want.numpy()) < 0.02
    for model, flag in ((f32, True), (bf16, False)):
        with pytest.raises(ValueError, match="bf16"):
            step(model, flag)(img, cam)


def test_evaluator_and_cli_bf16(capsys):
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    cfg = get_config("smoke_synthetic")
    dataset = build_eval_dataset(cfg)
    f32 = cfg.model.build(generator=torch.Generator().manual_seed(0))
    bf16 = cast_params_bf16(
        cfg.model.build(generator=torch.Generator().manual_seed(0)), "all")
    want, _ = Evaluator(f32, dataset, cfg.data).run(max_images=2)
    got, rows = Evaluator(bf16, dataset, cfg.data, bf16=True).run(
        max_images=2)
    assert len(rows) == 2 and len(got) == 9
    assert np.isfinite(np.asarray(rows)).all()
    assert abs(got["abs_rel"] - want["abs_rel"]) < 0.02 * want["abs_rel"] \
        + 0.02
    with pytest.raises(ValueError, match="bf16"):
        Evaluator(f32, dataset, cfg.data, bf16=True).run(max_images=1)
    test_cli.main(["smoke_synthetic", "--device", "cpu", "--max-images", "2",
                   "--bf16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bf16"] is True and line["images"] == 2
    np.testing.assert_allclose(line["abs_rel"], got["abs_rel"], rtol=1e-6)


# ---- bf16-compute training -------------------------------------------

def test_bf16_train_steps_track_f32_and_jax(monkeypatch):
    """8 steps on one 64x128 batch of 2 from bridged weights, lr 1e-4: the port's bf16
    losses stay within rtol 0.05 of its f32 run and of the JAX package's
    bf16 run and fall; masters, gradients, AdamW moments and BatchNorm
    statistics stay f32; the gradients of the sampling-offset and
    attention-weight layers, which pass through the f32 position cast, are
    not zero."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step
    from test_torch_train import (
        _identity_dropout, _no_dropout, _synthetic_batches, _tensors)

    _identity_dropout(monkeypatch)
    jcfg, tcfg = _model_configs(neck_sampling="windowed",
                                neck_hi_min_level=1, drop_path_rate=0.0)
    lr, steps = 1e-4, 8
    batch = _synthetic_batches(1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jbatch["img"],
                                  jbatch["cam_height"], seed=8)
    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_train_step(jmodel, donate=False, bf16=True)
    jax_losses = []
    for i in range(steps):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        jax_losses.append(float(jm["loss"]))

    def run(bf16):
        model = load_flax_variables(tcfg.build(), variables["params"],
                                    variables["batch_stats"])
        _no_dropout(model)
        state = TrainState(model, toptim.make_optimizer(model),
                           toptim.lr_schedule(lr, 10, 0),
                           torch.Generator().manual_seed(0))
        step = make_train_step(bf16=bf16)
        tensors = _tensors(batch)
        return [step(state, tensors)["loss"].item()
                for _ in range(steps)], state

    ref, _ = run(False)
    got, state = run(True)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0.05)
    np.testing.assert_allclose(got, jax_losses, rtol=0.05)
    assert got[-1] < got[0]
    model = state.model
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
    for st in state.optimizer.state.values():
        for t in st.values():
            if torch.is_tensor(t):
                assert t.dtype == torch.float32
    moved = 0
    for name, b in model.named_buffers():
        assert b.dtype in (torch.float32, torch.int64), name
        if name.endswith("num_batches_tracked"):
            assert b.item() == steps
        elif name.endswith("running_mean"):
            moved += 1
    assert moved > 0
    for att in ("self_attn", "multi_att"):
        for layer in ("sampling_offsets", "attention_weights"):
            g = getattr(getattr(model.neck, att), layer).weight.grad
            assert g.abs().sum().item() > 0, (att, layer)


def test_bf16_batchnorm_statistics_after_one_step():
    """After one bf16-compute step every buffer is f32 (or the step count)
    and every running statistic has moved, to the biased batch variance as
    flax stores it."""
    from test_torch_train import _synthetic_batches, _tensors

    cfg = get_config("smoke_synthetic")
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.named_buffers()}
    from gedepth_tpu_torch.train.steps import create_train_state
    state = create_train_state(model, cfg.optim, 10, seed=1)
    make_train_step(bf16=True)(state, _tensors(_synthetic_batches(1, 32,
                                                                  64)[0]))
    for name, b in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert b.item() == 1
            continue
        assert b.dtype == torch.float32, name
        assert not torch.equal(b, before[name]), name
    bn = model.backbone.bn1
    assert 0.9 < bn.running_var.min().item()      # 0.9·1 + 0.1·var >= 0.9


def test_train_loop_passes_bf16_compute():
    from gedepth_tpu_torch.train.loop import train

    cfg = get_config("smoke_synthetic")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, bf16_compute=True))
    state, history = train(cfg, max_iters=2, device="cpu")
    assert len(history) == 2
    assert all(np.isfinite(r["loss"]) for r in history)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


# ---- the timing CLI --------------------------------------------------

@pytest.mark.parametrize("flags", [(), ("--bf16",), ("--train-step",),
                                   ("--train-step", "--bf16"),
                                   ("--train-step", "--no-autotuner")])
def test_benchmark_cli(capsys, flags):
    from gedepth_tpu_torch.tools import benchmark

    benchmark.main(["smoke_synthetic", "--device", "cpu", "--iters", "2",
                    "--warmup", "1", "--height", "64", "--width", "128",
                    *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("Overall fps:")
    record = json.loads(lines[-2])
    want = {(): "f32", ("--bf16",): "bf16", ("--train-step",): "f32",
            ("--train-step", "--bf16"): "bf16_compute",
            ("--train-step", "--no-autotuner"): "f32, cuDNN heuristic"}[flags]
    assert record["dtype"] == want
    assert record["preset"] == "smoke_synthetic" and record["iters"] == 2
    assert record["shape"] == [64, 128] and record["batch"] == 1
    assert record["mode"] == ("train_step" if "--train-step" in flags
                              else "serve")
    assert record["host_ms_per_iter"] > 0
    # device metrics come from a card only
    assert record["device_ms_median"] is None
    assert record["device_busy_ms"] is None
    assert record["device_idle_share"] is None and record["card"] is None
    assert (record["first_step_ms"] is not None) == ("--train-step" in flags)


def test_benchmark_input_is_the_jax_tools():
    from gedepth_tpu_torch.tools.benchmark import benchmark_input

    img = np.random.default_rng(0).standard_normal(
        (1, 8, 16, 5)).astype(np.float32)
    img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
    np.testing.assert_array_equal(
        benchmark_input("adaptive", 1, 8, 16, "cpu").numpy(), img)
    assert benchmark_input("none", 2, 8, 16, "cpu").shape == (2, 8, 16, 3)


# ---- the constructors' defaults --------------------------------------

def test_default_sampling_is_the_jax_packages():
    """`GEDepth`, `HAHINeck` and `MSDeformAttention` built without a
    sampling argument on both sides: 'bilinear', and the JAX tree loads."""
    from gedepth_tpu.models.depther import GEDepth as JaxGEDepth
    from gedepth_tpu.models.hahi import (
        HAHINeck as JaxHAHINeck, MSDeformAttention as JaxMSDA)
    from gedepth_tpu_torch.convert import state_dict_from_flax
    from gedepth_tpu_torch.models.depther import GEDepth
    from gedepth_tpu_torch.models.hahi import HAHINeck, MSDeformAttention

    kw = dict(embed_dims=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
              neck_channels=(64, 16, 32, 64, 128), neck_embed_dim=32,
              neck_num_points=2, head_channels=16)
    jmodel, tmodel = JaxGEDepth(**kw), GEDepth(**kw)
    assert jmodel.neck_sampling == "bilinear"
    assert tmodel.neck.sampling == tmodel.neck.self_attn.sampling \
        == "bilinear"
    variables = _random_variables(jmodel.init, jnp.zeros((1, 32, 64, 5)),
                                  jnp.ones((1,)), seed=3)
    load_flax_variables(tmodel, variables["params"],
                        variables["batch_stats"])

    chans = (16, 24, 32, 40, 48)
    grids = ((16, 32), (8, 16), (4, 8), (2, 4), (1, 2))
    feats = [jnp.zeros((1, h_, w_, c)) for (h_, w_), c in zip(grids, chans)]
    jneck = JaxHAHINeck(in_channels=chans, out_channels=chans, embed_dim=32,
                        num_heads=2, num_points=3)
    tneck = HAHINeck(chans, chans, embed_dim=32, num_heads=2, num_points=3)
    assert jneck.sampling == tneck.sampling == "bilinear"
    nv = _random_variables(lambda k, x: jneck.init(k, x), feats, seed=4)
    sd = state_dict_from_flax({"neck": nv["params"]},
                              {"neck": nv["batch_stats"]})
    tneck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()},
                          strict=True)

    jatt = JaxMSDA(32, 2, 2, 3)
    tatt = MSDeformAttention(32, 2, 2, 3)
    assert jatt.sampling == tatt.sampling == "bilinear"
    levels = ((4, 8), (2, 4))
    q = jnp.zeros((1, 40, 32))
    ref = jnp.zeros((40, 2, 2))
    av = _random_variables(
        lambda k: jatt.init(k, q, q, q, ref, levels, True,
                            query_shapes=levels), seed=5)
    sd = state_dict_from_flax({"neck": {"self_attn": av["params"]}})
    tatt.load_state_dict({k[len("neck.self_attn."):]: v
                          for k, v in sd.items()}, strict=True)
