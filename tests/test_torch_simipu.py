"""`--simipu` (a SimIPU pretraining checkpoint's image backbone) in the
port's `tools.convert_torch_checkpoint`, against the JAX package's
`simipu_backbone_extract`, on the CPU: the kept keys and tensors equal the
JAX extraction's on the same file; the smoke model takes the backbone and
keeps the rest of its seeded initialisation; the CLI applies the flag.
"""
import numpy as np
import pytest
import torch

from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.convert.from_pth import (
    convert_checkpoint_file, simipu_backbone_extract)

torch.set_num_threads(1)


def _simipu_file(tmp_path):
    """A SimIPU-shaped checkpoint: the smoke model's backbone under
    `img_backbone.`, a point-cloud branch and a head the extraction
    drops, under `state_dict` as mmcv saves it."""
    model = get_config("smoke_synthetic").model.build(
        generator=torch.Generator().manual_seed(3))
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            sd["img_" + k] = (v + 0.5) if v.is_floating_point() else v
    sd["pts_backbone.conv.weight"] = torch.ones(4, 4)
    sd["img_neck.fpn.weight"] = torch.zeros(2)
    path = tmp_path / "simipu.pth"
    torch.save({"state_dict": sd}, path)
    return str(path), sd


def test_simipu_keys_match_jax(tmp_path):
    from gedepth_tpu.convert.torch_to_jax import (
        simipu_backbone_extract as jax_extract)

    _, sd = _simipu_file(tmp_path)
    got = simipu_backbone_extract(sd)
    want = jax_extract({k: v.numpy() for k, v in sd.items()})
    assert sorted(got) == sorted(want)
    assert all(k.startswith("backbone.") for k in got)
    assert "neck.fpn.weight" not in got and len(got) == len(sd) - 2
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_simipu_file_loads_the_backbone_only(tmp_path):
    path, sd = _simipu_file(tmp_path)
    model = get_config("smoke_synthetic").model.build(
        generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, report = convert_checkpoint_file(path, model, simipu=True)
    after = model.state_dict()
    for k, v in after.items():
        want = sd.get("img_" + k, before[k])
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    assert any(k.startswith("decode_head.") for k in report["missing_params"])
    assert not any(k.startswith("backbone.") for k in report["missing_params"])


@pytest.mark.parametrize("simipu", [False, True])
def test_convert_cli_applies_simipu(tmp_path, simipu, capsys):
    from gedepth_tpu_torch.tools import convert_torch_checkpoint as cli
    from gedepth_tpu_torch.train.checkpoint import load_params_only

    path, sd = _simipu_file(tmp_path)
    out = str(tmp_path / "out.npz")
    cli.main([path, "smoke_synthetic", out] + (["--simipu"] if simipu
                                               else []))
    assert "wrote" in capsys.readouterr().out
    model = load_params_only(out, get_config("smoke_synthetic").model.build())
    key = "backbone.stages.0.blocks.0.norm1.weight"
    got = model.state_dict()[key]
    if simipu:
        torch.testing.assert_close(got, sd["img_" + key], rtol=0, atol=0)
    else:
        assert not torch.equal(got, sd["img_" + key])
