"""One `make_zoo_train_step` step of `ZooDepther` 'binsformer' with the
preset's loss terms against the JAX package's step, on the CPU: SigLoss 10
on the final layer, the scene-class cross entropy 1e-2 on the class
query's logits, the auxiliary SigLoss of decoder layers 2 and 5 at 0.25 and
0.5, with the bin chamfer at 0.1 (on the final layer and, weighted, on the
auxiliary ones); with the chamfer off in
tests/test_torch_zoo_binsformer_train_nochamfer.py (one compiled JAX step
a file).

Widths and frames as tests/test_torch_zoo_binsformer.py's (Swin embed 16,
conv_dim 32, 16 bins, 64x96, batch 2, a scene class each), DropPath the
identity on both sides. Held: the loss and every metric against the JAX
step's (rtol 1e-4), the raw gradient of each parameter against JAX's,
||g − g_jax|| <= 1e-3·||g_jax|| + 1e-6 as tests/test_torch_zoo.py holds
them, the parameters after the step within 2·lr and the BatchNorm
statistics as that file holds them. A gradient that is 0 in exact
arithmetic (a LayerNorm bias in front of a BatchNorm, the bias of
`bins_embed` or `mask_embed` under a softmax, the decoder's level
embedding, which adds one vector to every key of a cross-attention) is rounding noise on both sides: the port's step in
float64 picks those leaves out (below 1e-6 of the largest leaf's norm),
and both sides' gradients there are held below that floor instead. The JAX step runs with
an optimizer that keeps the raw gradients as its state (`_capture`); the
JAX package's AdamW (with its clip) is then applied to them, which is what
its step does with them.
"""
import numpy as np
import optax
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_zoo import _assert_stats_match, _double_copy
from test_torch_zoo_adabins_train import _nyu_like_batch
from test_torch_zoo_binsformer import H, W, binsformer, no_droppath, \
    quiet  # noqa: F401 (a fixture)

torch.set_num_threads(1)

LR = 1e-6


def _capture():
    """An optax transformation that changes no parameter and keeps the
    gradients it is given as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def step_against_jax(chamfer):
    """The port's step and the JAX package's at `chamfer` from the same
    bridged weights and batch, held as the module's docstring says;
    returns the port's metrics."""
    from gedepth_tpu.train import optim as joptim
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_zoo_train_step as jax_step
    from gedepth_tpu_torch.train import optim as toptim
    from gedepth_tpu_torch.train.steps import TrainState, make_zoo_train_step

    optim = get_config("binsformer_nyu").optim
    batch = dict(_nyu_like_batch(H, W), scene_class=np.array([3, 17],
                                                            np.int32))
    jmodel, variables, model = binsformer(batch["img"], seed=11)
    quiet(model)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                        np.float32))
               for k in ("img", "depth_gt", "cam_height")}
    tensors["scene_class"] = torch.from_numpy(batch["scene_class"]).long()
    step = make_zoo_train_step(
        optim.sig_loss_weight, optim.aux_loss_indices,
        optim.aux_loss_weights, optim.class_ce_weight, chamfer)

    def run(m, inputs):
        return step(TrainState(m, toptim.make_optimizer(m),
                               toptim.lr_schedule(LR, 10, 0)), inputs)

    f64 = _double_copy(model)
    norm64 = run(f64, {k: v if k == "scene_class" else v.double()
                       for k, v in tensors.items()})["grad_norm"].item()
    grads64 = {n: p.grad * max(norm64, 35.0) / 35.0
               for n, p in f64.named_parameters()}
    f64 = _double_copy(model)
    tm = run(model, tensors)

    capture = _capture()
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=capture.init(variables["params"]),
                           tx=capture)
    jstate, jm = jax_step(
        jmodel, optim.sig_loss_weight, optim.aux_loss_indices,
        optim.aux_loss_weights, optim.class_ce_weight, chamfer,
        donate=False)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    raw = jstate.opt_state

    assert set(tm) == {"loss", "loss_depth", "loss_ce", "aux_loss_depth_2",
                       "aux_loss_depth_5", "grad_norm", "lr"} | (
        {"loss_chamfer"} if chamfer else set())
    assert set(tm) == set(jm) | {"lr"}
    for key in jm:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(
        tm["loss"].item(), sum(tm[k].item() for k in tm
                               if k.startswith(("loss_", "aux_"))),
        rtol=1e-6)
    unclip = max(tm["grad_norm"].item(), 35.0) / 35.0
    want_g = state_dict_from_flax(jax.device_get(raw))
    norm = torch.linalg.vector_norm
    floor = 1e-6 * max(norm(g).item() for g in grads64.values())
    for name, p in model.named_parameters():
        g, want = p.grad * unclip, want_g[name]
        if norm(grads64[name]) < floor:
            # 0 in exact arithmetic: rounding noise on both sides
            assert norm(g) < floor and norm(want) < floor, name
        else:
            assert norm(g - want) <= 1e-3 * norm(want) + 1e-6, name

    tx, _ = joptim.make_optimizer(LR, 10, 0)
    updates, _ = jax.jit(tx.update)(raw, tx.init(variables["params"]),
                                    variables["params"])
    want = state_dict_from_flax(
        jax.device_get(optax.apply_updates(variables["params"], updates)),
        jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(want) == set(got)
    f64(tensors["img"].double())
    _assert_stats_match(model, jax.device_get(jstate.batch_stats), f64)
    for key, value in want.items():
        if not key.endswith(("num_batches_tracked", "running_mean",
                             "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=2 * LR, err_msg=key)
    return tm


def test_zoo_binsformer_train_step_matches_jax(no_droppath):
    tm = step_against_jax(0.1)
    assert tm["loss_chamfer"].item() > 0
