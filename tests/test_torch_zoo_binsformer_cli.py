"""`binsformer_nyu` through the port's entry points at smoke width, on the
CPU, from an NYU tree of `tools.make_tree` (3 scenes, 96x128 frames, the
scene classes on): tools.train in f32, then --bf16-compute resuming its
checkpoint, with the scene-class and auxiliary losses in the log;
tools.test with flip-TTA and --slide on the best `.npz`; the exported eval
step against the eager one, with kernels A and B in the program as the
port's ops; `inference_depther` on a frame's path.

Smoke widths: Swin embed 16, head conv_dim 32, 16 bins, crop 64x96, batch
2. Nothing here imports JAX.
"""
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.configs import apply_options, get_config
from gedepth_tpu_torch.tools.make_tree import make_nyu_tree

torch.set_num_threads(1)

SIZE = (96, 128)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nyu"))
    return dict(make_nyu_tree(root, size=SIZE, frames=2, seed=4), root=root)


def _opts(tree):
    return [f"data.data_root={tree['root']}", "data.crop_size=(64,96)",
            "train.global_batch=2", "train.eval_interval=2",
            "train.checkpoint_interval=2", "train.log_interval=1",
            "optim.warmup_iters=1", "model.head_channels=32",
            "model.backbone_embed_dims=16", "model.n_bins=16"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_zoo_binsformer_cli(tree, tmp_path, capsys):
    from gedepth_tpu_torch.apis import inference_depther
    from gedepth_tpu_torch.apis.export import export_depther
    from gedepth_tpu_torch.apis.inference import init_depther
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    opts = _opts(tree)
    work = tmp_path / "binsformer"
    base = ["binsformer_nyu", "--device", "cpu", "--work-dir", str(work),
            "--eval-max-images", "1"]
    train_cli.main(base + ["--max-iters", "2", "--options", *opts])
    best = _last_json(capsys)
    assert best["iter"] == 2 and np.isfinite(best["abs_rel"])
    train_cli.main(base + ["--max-iters", "3", "--bf16-compute",
                           "--resume-from", str(work / "ckpts"),
                           "--options", *opts])
    capsys.readouterr()
    records = [json.loads(line) for line in
               (work / "train.log.jsonl").read_text().splitlines()]
    train = [r for r in records if r["mode"] == "train"]
    assert [r["iter"] for r in train] == [1, 2, 3]
    for r in train:
        terms = ("loss", "loss_depth", "loss_ce", "aux_loss_depth_2",
                 "aux_loss_depth_5")
        assert all(np.isfinite(r[k]) for k in terms), r
        assert "loss_chamfer" not in r
        np.testing.assert_allclose(r["loss"], sum(r[k] for k in terms[1:]),
                                   rtol=1e-5)
    assert sorted(os.listdir(work)) == ["best_abs_rel.npz", "ckpts", "tb",
                                        "train.log.jsonl"]
    npz = str(work / "best_abs_rel.npz")
    for flags in ([], ["--slide"]):
        test_cli.main(["binsformer_nyu", npz, "--device", "cpu",
                       "--max-images", "2", *flags, "--options", *opts])
        line = _last_json(capsys)
        assert line["images"] == 2 and np.isfinite(line["abs_rel"]), flags

    cfg = apply_options(get_config("binsformer_nyu"), opts)
    exported, weights, meta = export_depther(cfg, hw=SIZE, flip_tta=True,
                                             device="cpu", checkpoint=npz)
    assert meta["ops"] == ["gedepth_torch::msda",
                           "gedepth_torch::window_attention"]
    assert meta["input"]["img"] == [1, *SIZE, 3]
    img = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, *SIZE, 3)).astype(np.float32))
    cam = torch.full((1,), 1.65)
    handle = init_depther(cfg, device="cpu", flip_tta=True, checkpoint=npz)
    with torch.no_grad():
        got = exported.module()(weights, img, cam)
    assert torch.equal(got, handle.eval_step(img, cam))

    frame = osp.join(tree["root"], "kitchen_0011", "rgb_00001.png")
    depth = inference_depther(handle, frame)
    assert depth.shape == SIZE and np.isfinite(depth).all()
    assert depth.min() >= 1e-3 and depth.max() <= 10.0
