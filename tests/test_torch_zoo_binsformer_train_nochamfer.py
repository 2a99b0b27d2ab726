"""One `make_zoo_train_step` step of `ZooDepther` 'binsformer' with the
preset's loss terms and the bin chamfer off (the preset's setting) against
the JAX package's step, on the CPU, held as
tests/test_torch_zoo_binsformer_train.py holds the step at chamfer 0.1 (one
compiled JAX step a file).
"""
from test_torch_zoo_binsformer import no_droppath  # noqa: F401 (a fixture)
from test_torch_zoo_binsformer_train import step_against_jax


def test_zoo_binsformer_train_step_without_chamfer_matches_jax(no_droppath):
    tm = step_against_jax(0.0)
    assert "loss_chamfer" not in tm
