"""The port's ViT, DPT head and `ZooDepther` 'dpt' against the JAX package,
on the CPU.

Seeded numpy variables for the JAX modules (`_random_variables`), carried
to the port with `state_dict_from_flax`; the same seeded inputs through
both. Smoke widths as tests/test_zoo_cli.py shrinks `dpt_kitti`: ViT embed
32, depth 4, patch 16, head channels 16, 64x128 frames (a 4x8 patch grid).

Tolerances as tests/test_torch_zoo.py's: rtol 1e-4 with atol 1e-5 of each
output's largest value for features, 1e-3 m for depth; train steps: losses
rtol 1e-4, the raw gradients tensor by tensor ||g_port − g_jax|| <=
1e-3·||g_jax|| + 1e-6, parameters after the step atol 2·lr.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.configs import get_config as jax_get_config
from gedepth_tpu_torch.configs import apply_options, get_config
from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_gedepth import _random_variables
from test_torch_zoo import _close, _synthetic_batches

torch.set_num_threads(1)

H, W = 64, 128
SHRINK = dict(head_channels=16, backbone_embed_dims=32, backbone_depth=4)
OPTS = ["data.dataset=synthetic", "data.synthetic_size=4",
        "data.crop_size=(64,128)", "data.eval_size=(64,128)",
        "train.global_batch=2", "train.eval_interval=2",
        "train.checkpoint_interval=2", "train.log_interval=1",
        "optim.warmup_iters=1", "model.head_channels=16",
        "model.backbone_embed_dims=32", "model.backbone_depth=4"]


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def model_configs(name, **over):
    """(JAX, port) ModelConfigs of a preset with `over` replaced."""
    return (dataclasses.replace(jax_get_config(name).model, **over),
            dataclasses.replace(get_config(name).model, **over))


def bridged(name, img, seed=1, **over):
    """(JAX model, its seeded variables, the port's model with them, loaded
    strictly by `load_flax_variables`)."""
    from gedepth_tpu_torch.convert import load_flax_variables

    jcfg, tcfg = model_configs(name, **over)
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(img), None,
                                  seed=seed)
    tmodel = load_flax_variables(tcfg.build(), variables["params"],
                                 variables.get("batch_stats", {}))
    return jmodel, variables, tmodel


def image(seed=0, batch=2, h=H, w=W, channels=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, h, w, channels)).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 128), (70, 135)])
def test_vit_tokens_match_jax(hw):
    """Every block's tokens (class token first) and patch grid; 70x135 is
    padded to 80x144 (a 5x9 grid, the pretraining grid resized to it)."""
    from gedepth_tpu.models.vit import VisionTransformer as JaxViT
    from gedepth_tpu_torch.models.vit import VisionTransformer

    img = image(seed=2, h=hw[0], w=hw[1], channels=3)
    jmodel = JaxViT(embed_dims=32, depth=4, num_heads=4,
                    out_indices=(0, 1, 2, 3))
    variables = _random_variables(jmodel.init, jnp.asarray(img), seed=3)
    sd = state_dict_from_flax({"backbone": variables["params"]})
    tmodel = VisionTransformer(embed_dims=32, depth=4, num_heads=4,
                               out_indices=(0, 1, 2, 3)).eval()
    tmodel.load_state_dict(_strip(sd, "backbone."), strict=True)
    want = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    grid = (-(-hw[0] // 16), -(-hw[1] // 16))
    assert len(got) == len(want) == 4
    for i, ((g, ghw), (w, whw)) in enumerate(zip(got, want)):
        assert ghw == tuple(whw) == grid
        assert g.shape == (2, 1 + grid[0] * grid[1], 32)
        _close(g.numpy(), w, err_msg=f"block {i}")


def test_out_indices_are_the_jax_rule():
    from gedepth_tpu_torch.models.vit import out_indices_for

    for depth in (4, 6, 12, 24):
        assert out_indices_for(depth) == tuple(
            round((i + 1) * depth / 4) - 1 for i in range(4))
    assert out_indices_for(12) == (2, 5, 8, 11)


def test_dpt_head_matches_jax():
    """The head alone on four token maps with class tokens (a 4x8 grid,
    batch 2): depth (2, 1, 64, 128)."""
    from gedepth_tpu.models.dpt import DPTHead as JaxDPTHead
    from gedepth_tpu_torch.models.dpt import DPTHead

    post = (8, 8, 16, 32)
    rng = np.random.default_rng(4)
    tokens = [rng.standard_normal((2, 33, 32)).astype(np.float32)
              for _ in range(4)]
    jhead = JaxDPTHead(post_process_channels=post, channels=16)
    jin = [(jnp.asarray(t), (4, 8)) for t in tokens]
    # the grid sizes stay Python ints: closed over, not traced
    variables = _random_variables(lambda key: jhead.init(key, jin), seed=5)
    sd = state_dict_from_flax({"decode_head": variables["params"]})
    head = DPTHead(32, post, channels=16).eval()
    head.load_state_dict(_strip(sd, "decode_head."), strict=True)
    want = jhead.apply(variables, jin)
    with torch.no_grad():
        got = head([(torch.from_numpy(t), (4, 8)) for t in tokens])
    assert got.shape == (2, 1, H, W)
    _close(got.numpy().transpose(0, 2, 3, 1), want)


def test_deconv_is_the_jax_dense_and_depth_to_space():
    """`Deconv` against the JAX `_Deconv` at factor 4 and 2: the Dense
    kernel's (C, k·k·F) columns in the order (k_y, k_x, F)."""
    from gedepth_tpu.models.dpt import _Deconv
    from gedepth_tpu_torch.models.dpt import Deconv

    for factor in (4, 2):
        x = image(seed=factor, h=3, w=5, channels=6)
        jmod = _Deconv(features=7, factor=factor)
        variables = _random_variables(jmod.init, jnp.asarray(x), seed=6)
        sd = state_dict_from_flax({"decode_head": {"reassemble0" if factor
                                                   == 4 else "reassemble1":
                                                   {"resize": variables[
                                                       "params"]}}})
        mod = Deconv(6, 7, factor)
        i = 0 if factor == 4 else 1
        mod.load_state_dict(_strip(
            sd, f"decode_head.reassemble_blocks.resize_layers.{i}."))
        want = jmod.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        _close(got.numpy().transpose(0, 2, 3, 1), want, err_msg=str(factor))


def test_zoo_dpt_matches_jax():
    """`ZooDepther` 'dpt' (5-channel input, RGB read): eval depth,
    `predict_depth`, and the train-mode forward (nothing in a ViT or the
    DPT head differs in training)."""
    img = image()
    jmodel, variables, tmodel = bridged("dpt_kitti", img, **SHRINK)
    x = torch.from_numpy(img)
    want = jmodel.apply(variables, jnp.asarray(img))
    want_pred = jmodel.apply(variables, jnp.asarray(img),
                             method=jmodel.predict_depth)
    want_train = jmodel.apply(variables, jnp.asarray(img), None, True)
    with torch.no_grad():
        got = tmodel(x)
        got_pred = tmodel.predict_depth(x)
        tmodel.train()
        got_train = tmodel(x)
    assert "bin_edges" not in got and got["y"] is None
    for g, w in ((got["depth"], want["depth"]), (got_pred, want_pred),
                 (got_train["depth"], want_train["depth"])):
        assert g.shape == (2, H, W, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


def jax_zoo_grads(jmodel, variables, batch, weight):
    """The raw gradients of the two terms of the loss `make_zoo_train_step`
    takes, in one program: weight · SigLoss, and the bin-chamfer distance
    at weight 1 (zero for a model without bin edges)."""
    from gedepth_tpu.models.losses import sigloss
    from gedepth_tpu.models.losses_extra import bins_chamfer_loss
    from gedepth_tpu.ops.resize import resize_bilinear

    gt = jnp.asarray(batch["depth_gt"])[..., None]

    def forward(params):
        out, _ = jmodel.apply(
            {"params": params,
             "batch_stats": variables.get("batch_stats", {})},
            jnp.asarray(batch["img"]), None, True, mutable=["batch_stats"])
        return out

    def depth_loss(params):
        d = resize_bilinear(forward(params)["depth"], gt.shape[1:3],
                            align_corners=True)
        return weight * sigloss(d, gt)

    def chamfer_loss(params):
        edges = forward(params).get("bin_edges")
        if edges is None:
            return jnp.zeros(())
        return bins_chamfer_loss(edges, gt[..., 0],
                                 min_depth=jmodel.min_depth, loss_weight=1.0)

    return jax.jit(lambda p: (jax.grad(depth_loss)(p),
                              jax.grad(chamfer_loss)(p)))(variables["params"])


def zoo_step_against_jax(name, batch, chamfers, seed=6, lr=1e-6, **over):
    """One `make_zoo_train_step` step of the port for each chamfer weight,
    each from the same bridged weights and batch, against the JAX package:
    the JAX step at the last weight (loss, loss terms, gradient norm,
    parameters and BatchNorm statistics after the step), and the raw
    gradients at every weight, each tensor within JAX's own distance from
    the port's step in float64 on top of the tolerance (a gradient that is
    0 in exact arithmetic, such as a BatchNorm bias's in front of another
    BatchNorm, is rounding noise on both sides). Returns the port's metrics
    by weight."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_zoo_train_step as jax_step
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState, make_zoo_train_step
    from test_torch_zoo import _assert_stats_match, _double_copy

    weight = get_config(name).optim.sig_loss_weight
    jmodel, variables, model = bridged(name, batch["img"], seed=seed, **over)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
               for k in ("img", "depth_gt", "cam_height")}
    g_depth, g_chamfer = (state_dict_from_flax(g) for g in jax_zoo_grads(
        jmodel, variables, batch, weight))
    results = {}
    for chamfer in chamfers:
        model.load_state_dict(start)
        f64 = _double_copy(model)
        step = make_zoo_train_step(weight, chamfer_weight=chamfer)
        norm64 = step(TrainState(f64, toptim.make_optimizer(f64),
                                 toptim.lr_schedule(lr, 10, 0)),
                      {k: v.double() for k, v in tensors.items()})[
            "grad_norm"].item()
        grads64 = {n: p.grad * max(norm64, 35.0) / 35.0
                   for n, p in f64.named_parameters()}
        model.load_state_dict(start)
        f64 = _double_copy(model)
        tm = step(TrainState(model, toptim.make_optimizer(model),
                             toptim.lr_schedule(lr, 10, 0)), tensors)
        results[chamfer] = tm
        unclip = max(tm["grad_norm"].item(), 35.0) / 35.0
        for pname, p in model.named_parameters():
            g = p.grad * unclip
            want = g_depth[pname] + chamfer * g_chamfer[pname]
            jax_err = torch.linalg.vector_norm(want - grads64[pname])
            assert torch.linalg.vector_norm(g - want) <= (
                1e-3 * torch.linalg.vector_norm(want) + 1e-6 + jax_err), (
                    chamfer, pname)
    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables.get("batch_stats", {}),
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jm = jax_step(jmodel, sig_loss_weight=weight,
                          chamfer_weight=chamfer, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    assert set(tm) == set(jm) | {"lr"}
    for key in jm:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
    want = state_dict_from_flax(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(want) == set(got)
    if jstate.batch_stats:
        f64(tensors["img"].double())
        _assert_stats_match(model, jax.device_get(jstate.batch_stats), f64)
    for key, value in want.items():
        if not key.endswith(("num_batches_tracked", "running_mean",
                             "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=2 * lr, err_msg=key)
    return results


def test_zoo_dpt_train_step_matches_jax():
    """chamfer_weight 0 and 0.1: a DPT gives no bin edges, so both steps
    are the SigLoss step (weight 10), with no `loss_chamfer`, in both
    packages."""
    batch = _synthetic_batches(1)[0]
    results = zoo_step_against_jax("dpt_kitti", batch, (0.0, 0.1), **SHRINK)
    for tm in results.values():
        assert set(tm) == {"loss", "loss_depth", "grad_norm", "lr"}
    assert results[0.0]["loss"].item() == results[0.1]["loss"].item()


def test_zoo_dpt_decay_mask_matches_jax():
    """`optim.decays` over the port's parameter names equals the JAX
    `decay_mask` over the bridged tree: the ViT's ln1/ln2 decay there
    (only names that begin with 'norm' do not)."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu_torch.train import optim as toptim

    jcfg, tcfg = model_configs("dpt_kitti", **SHRINK)
    variables = _random_variables(jcfg.build().init,
                                  jnp.zeros((1, H, W, 5)), None)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda d, p: np.full(np.shape(p), float(d)),
        joptim.decay_mask(variables["params"]), variables["params"]))
    names = {n for n, _ in tcfg.build().named_parameters()}
    assert set(want) == names
    for name in names:
        assert toptim.decays(name) == bool(want[name].all()), name


def test_zoo_dpt_npz_both_ways(tmp_path):
    """The port's params-only `.npz` loads in the JAX `load_params_only`
    and gives the JAX model the port's depth; a JAX `.npz` loads into the
    port strictly. The ViT's q, k, v kernels go out with 1 head (embed 32:
    max(1, 32 // 64))."""
    from gedepth_tpu.train import checkpoint as jckpt
    from gedepth_tpu_torch.train import checkpoint as tckpt

    img = image(batch=1)
    jmodel, variables, tmodel = bridged("dpt_kitti", img, seed=7, **SHRINK)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_only(path, variables["params"], {})
    _, tcfg = model_configs("dpt_kitti", **SHRINK)
    loaded = tckpt.load_params_only(path, tcfg.build())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    path = str(tmp_path / "port.npz")
    tmodel = tcfg.build(generator=torch.Generator().manual_seed(11))
    tckpt.save_params_only(path, tmodel)
    params, stats = jckpt.load_params_only(path, variables["params"], {})
    want = jmodel.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)


def test_zoo_dpt_pth_loads_as_the_jax_converter(tmp_path):
    """A reference-named DPT `.pth` (a textbook DPT head under
    `decode_head.`, an mmseg-named ViT under `backbone.`): the port loads
    the head, as the JAX converter does (the transposed convs' biases
    spread over their sub-pixels), and both give the same depth from the
    same backbone; both report the same unmapped keys, and the key that
    JAX sends to GEDepth's patch embed is the port's unused one."""
    from gedepth_tpu.convert import convert_state_dict as jax_convert
    from gedepth_tpu.convert.torch_to_jax import _merge_into
    from gedepth_tpu_torch.convert.from_pth import convert_checkpoint_file
    from test_torch_zoo2_textbook import TDPTHead

    torch.manual_seed(0)
    head = TDPTHead(32, (8, 8, 16, 32), 16)
    sd = {f"decode_head.{k}": v for k, v in head.state_dict().items()}
    for k, shape in (("cls_token", (1, 1, 32)), ("pos_embed", (1, 197, 32)),
                     ("patch_embed.projection.weight", (32, 3, 16, 16)),
                     ("patch_embed.projection.bias", (32,)),
                     ("layers.0.ln1.weight", (32,))):
        sd[f"backbone.{k}"] = torch.randn(shape)
    path = str(tmp_path / "dpt.pth")
    torch.save({"state_dict": sd}, path)

    img = image(seed=8, batch=1)
    jmodel, variables, model = bridged("dpt_kitti", img, seed=9, **SHRINK)
    params, _, jax_unmapped = jax_convert(
        {k: v.numpy() for k, v in sd.items()})
    jparams, missing = _merge_into(variables["params"], params)
    assert all(m.startswith("backbone/") for m in missing)
    _, report = convert_checkpoint_file(path, model)
    assert sorted(report["unmapped_torch_keys"]) == sorted(jax_unmapped)
    assert report["unused_torch_keys"] == [
        "backbone.patch_embed.projection.bias",
        "backbone.patch_embed.projection.weight"]
    assert sorted(report["missing_params"]) == sorted(
        k for k, _ in model.named_parameters() if k.startswith("backbone."))
    want = jmodel.apply({"params": jparams}, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(
        want["depth"]), rtol=1e-4, atol=1e-3)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_vit_attention_goes_out_with_the_zoos_head_count():
    """A 128-wide ViT (2 heads of 64: the zoo's rule max(1, C // 64))
    goes out to flax q, k, v kernels (128, 2, 64), biases (2, 64) and an
    output kernel (2, 64, 128), the shapes of the JAX ViT's tree, and
    comes back equal."""
    from gedepth_tpu.models.vit import VisionTransformer as JaxViT
    from gedepth_tpu_torch.convert.from_jax import (
        _flatten, flax_variables_from_state_dict)
    from gedepth_tpu_torch.models.vit import VisionTransformer

    model = VisionTransformer(embed_dims=128, depth=1, num_heads=2,
                              out_indices=(0,))
    sd = {f"backbone.{k}": v for k, v in model.state_dict().items()}
    params, _ = flax_variables_from_state_dict(sd)
    want = _random_variables(JaxViT(embed_dims=128, depth=1, num_heads=2,
                                    out_indices=(0,)).init,
                             jnp.zeros((1, 32, 32, 3)))
    got = dict(_flatten(params["backbone"]))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in _flatten(want["params"])}
    back = state_dict_from_flax(params)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_zoo_dpt_cli(tmp_path, capsys):
    """tools.train in f32 and --bf16-compute (the second resuming the
    first's checkpoint), tools.test with flip-TTA and --slide on the best
    `.npz`, and the exported eval step against the eager one."""
    from gedepth_tpu_torch.apis.export import export_depther
    from gedepth_tpu_torch.apis.inference import init_depther
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    work = tmp_path / "dpt"
    base = ["dpt_kitti", "--device", "cpu", "--work-dir", str(work),
            "--eval-max-images", "1"]
    train_cli.main(base + ["--max-iters", "2", "--options", *OPTS])
    best = _last_json(capsys)
    assert best["iter"] == 2 and np.isfinite(best["abs_rel"])
    train_cli.main(base + ["--max-iters", "3", "--bf16-compute",
                           "--resume-from", str(work / "ckpts"),
                           "--options", *OPTS])
    capsys.readouterr()
    records = [json.loads(line) for line in
               (work / "train.log.jsonl").read_text().splitlines()]
    train = [r for r in records if r["mode"] == "train"]
    assert [r["iter"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert sorted(os.listdir(work)) == ["best_abs_rel.npz", "ckpts", "tb",
                                        "train.log.jsonl"]
    npz = str(work / "best_abs_rel.npz")
    for flags in ([], ["--slide"]):
        test_cli.main(["dpt_kitti", npz, "--device", "cpu", "--max-images",
                       "2", *flags, "--options", *OPTS])
        line = _last_json(capsys)
        assert line["images"] == 2 and np.isfinite(line["abs_rel"]), flags

    cfg = apply_options(get_config("dpt_kitti"), OPTS)
    exported, weights, meta = export_depther(cfg, hw=(H, W), flip_tta=True,
                                             device="cpu", checkpoint=npz)
    assert meta["ops"] == [] and meta["input"]["img"] == [1, H, W, 5]
    img = torch.from_numpy(image(seed=10, batch=1))
    cam = torch.full((1,), 1.65)
    with torch.no_grad():
        got = exported.module()(weights, img, cam)
    want = init_depther(cfg, device="cpu", flip_tta=True,
                        checkpoint=npz).eval_step(img, cam)
    assert torch.equal(got, want)
