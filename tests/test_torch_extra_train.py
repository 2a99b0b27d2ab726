"""The CPU half of `chip_smoke.py` phase 39 at smoke width: `tools.train`
of the smoke preset (no PE: the extra datasets carry RGB alone) on a
`tools.make_tree` Cityscapes tree at 128x256 for 2 steps with the loop's
evaluation of one test frame at its own size; `tools.test --format-only`
on a custom folder (a PNG and a JPEG); and `ASNDepthHeadV2` with its loss
dict and `ASNDepthHead`, forward and backward: finite, of the expected
shapes, every parameter given a gradient. The card half holds the same
runs at full width against the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.tools import make_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    cs = str(tmp_path_factory.mktemp("cityscapes"))
    custom = str(tmp_path_factory.mktemp("custom"))
    return {"cityscapes": dict(make_tree.make_cityscapes_tree(
                cs, size=(128, 256), frames=2, seed=1), root=cs),
            "custom": make_tree.make_custom_tree(custom, size=(48, 64))}


def test_smoke_trains_and_evaluates_on_cityscapes(trees, tmp_path, capsys):
    from gedepth_tpu_torch.tools import train as train_cli

    t = trees["cityscapes"]
    work = tmp_path / "run"
    train_cli.main(["smoke_synthetic", "--device", "cpu", "--work-dir",
                    str(work), "--max-iters", "2", "--eval-max-images", "1",
                    "--options", "data.dataset=cityscapes",
                    f"data.data_root={t['root']}",
                    f"data.train_split={t['train']}",
                    f"data.test_split={t['test']}", "model.pe_variant=none",
                    "train.log_interval=1"])
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert best["iter"] == 2 and best["images"] == 1
    assert np.isfinite(best["abs_rel"]) and np.isfinite(best["rmse"])
    records = [json.loads(line) for line in open(work / "train.log.jsonl")]
    steps = [r for r in records if r["mode"] == "train"]
    assert len(steps) == 2 and all(np.isfinite(r["loss"]) for r in steps)
    assert os.path.exists(work / "best_abs_rel.npz")


def test_format_only_on_the_custom_folder(trees, tmp_path):
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.utils.png import read_png

    out = tmp_path / "format"
    test_cli.main(["smoke_synthetic", "--device", "cpu", "--max-images", "2",
                   "--format-only", "--format-dir", str(out), "--options",
                   "data.dataset=custom",
                   f"data.data_root={trees['custom']['root']}",
                   "model.pe_variant=none"])
    shapes = {n: read_png(str(out / n)).shape for n in sorted(os.listdir(
        out))}
    assert shapes == {"frame_a.png": (48, 64), "frame_b.png": (530, 730)}
    assert read_png(str(out / "frame_a.png")).dtype == np.uint16


def test_asn_heads_forward_and_backward():
    from gedepth_tpu_torch.models.asn import ASNDepthHeadV2, asn_losses
    from gedepth_tpu_torch.models.experiment_heads import ASNDepthHead
    from gedepth_tpu_torch.models.layers import init_weights
    from gedepth_tpu_torch.models.losses import sigloss

    g = torch.Generator().manual_seed(0)
    v2 = ASNDepthHeadV2(input_features_dim=16).train()
    head = ASNDepthHead((8, 16, 32), channels=8, focal=60.0).train()
    for m in (v2, head):
        init_weights(m, g)
    K = torch.tensor([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1.0]]
                     ).expand(2, 3, 3).contiguous()
    out = v2(torch.randn(2, 6, 8, 16, generator=g), K)
    gt = torch.rand(2, 48, 64, generator=g) * 9 + 0.5
    losses = asn_losses(out, gt, torch.randn(2, 48, 64, 3, generator=g),
                        torch.randn(2, 48, 64, 3, generator=g))
    assert out["normals"].shape == (2, 48, 64, 3)
    depth, normals = head([torch.randn(2, 32 >> i, 48 >> i, c, generator=g)
                           for i, c in enumerate((8, 16, 32))])
    losses["sigloss"] = sigloss(depth[..., 0], torch.rand(2, 32, 48) + 1)
    assert depth.shape == (2, 32, 48, 1) and normals.shape == (2, 32, 48, 3)
    sum(losses.values()).backward()
    for m in (v2, head):
        for n, p in m.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), n
    assert all(torch.isfinite(v) for v in losses.values())
