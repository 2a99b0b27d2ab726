"""One train step of the PyTorch port's vanilla and baseline models against
`gedepth_tpu.train.steps.make_train_step`, on the CPU (the adaptive model's
three steps are in tests/test_torch_train.py).

Smoke widths at 64x128, batch 2, lr 1e-6, DropPath and dropout off, the JAX
model's seeded numpy variables carried over by `load_flax_variables`.
Tolerances: losses and gradient norm rtol 1e-4, BatchNorm statistics rtol
1e-4, parameters atol 2·lr (an Adam update is ≈ lr·sign(g)).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu.train import optim as joptim
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from gedepth_tpu_torch.train import optim as toptim
from gedepth_tpu_torch.train.steps import TrainState, make_train_step

from test_torch_gedepth import _random_variables
from test_torch_train import _identity_dropout, _no_dropout
from test_torch_variants import H, W, _model_configs

torch.set_num_threads(1)


@pytest.mark.parametrize("pe_variant,sampling", [
    ("vanilla", "bilinear"), ("none", "windowed_compat")])
def test_train_step_of_other_variants_matches_jax(monkeypatch, pe_variant,
                                                  sampling):
    """One step of `make_train_step` on both sides from the same weights and
    batch (64x128, batch 2, DropPath and dropout off): no slope loss outside
    the adaptive variant, 3-channel samples for the baseline."""
    from gedepth_tpu.train.state import TrainState as JaxTrainState
    from gedepth_tpu.train.steps import make_train_step as jax_train_step
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline

    _identity_dropout(monkeypatch)
    jcfg, tcfg = _model_configs(pe_variant, sampling, drop_path_rate=0.0)
    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=(H, W))
    batch = TrainLoader(
        SyntheticGroundDataset(size=4, height=H, width=W,
                               use_pe=pe_variant != "none"),
        build_train_pipeline(data), 2, seed=0).make_batch(0)
    assert batch["img"].shape[-1] == (3 if pe_variant == "none" else 5)
    assert ("pe_k_gt" in batch) == (pe_variant != "none")

    lr = 1e-6
    jmodel = jcfg.build()
    variables = _random_variables(jmodel.init, jnp.asarray(batch["img"]),
                                  jnp.asarray(batch["cam_height"]), seed=4)
    tx, _ = joptim.make_optimizer(lr, 10, 0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jstate, jm = jax_train_step(jmodel, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    model = load_flax_variables(tcfg.build(), variables["params"],
                                variables["batch_stats"])
    _no_dropout(model)
    state = TrainState(model, toptim.make_optimizer(model),
                       toptim.lr_schedule(lr, 10, 0),
                       torch.Generator().manual_seed(0))
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
               for k, v in batch.items() if k != "index"}
    tm = make_train_step()(state, tensors)
    assert "loss_slope" not in tm and "loss_slope" not in jm
    for key in ("loss", "loss_depth", "grad_norm"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    want = state_dict_from_flax(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = (dict(rtol=1e-4, atol=1e-6)
               if key.endswith(("running_mean", "running_var"))
               else dict(rtol=0, atol=2 * lr))
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **tol)
    assert all(p.grad is not None for p in model.parameters())
