"""The port's NYU data path against the JAX package, on the CPU: the
dataset on a `tools.make_tree` NYU tree (3 scenes of 3 frames at 480x640,
a `None` pair), its scene classes, the train chain (NYUCrop, rotation,
flip, the 416x544 crop, colour, normalisation), the test chain (the frame's
own size), the loader's batches, the eval crop, the JPEG route, the
`/`-leading split rule, and `adabins_nyu` trained and evaluated from the
tree by the tools.

Samples and batches are held as tests/test_torch_transforms_cv2.py holds
the chains: every field exactly equal but the rotated RGB, within 1e-3
(the port's float32 bilinear blend against cv2's fused multiply-adds).
"""
import dataclasses
import json
import os
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.tools.make_tree import make_nyu_tree

from test_torch_transforms_cv2 import _assert_same, _copy

torch.set_num_threads(1)

FRAMES = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nyu"))
    return dict(make_nyu_tree(root, frames=FRAMES, seed=3), root=root)


def _datasets(tree, split, test_mode=False, scene_classes=False):
    from gedepth_tpu.data.extra_datasets import NYUDataset as JaxNYU
    from gedepth_tpu_torch.data.nyu import NYUDataset

    kw = dict(test_mode=test_mode, scene_classes=scene_classes)
    return (NYUDataset(tree["root"], split, **kw),
            JaxNYU(tree["root"], split, **kw))


@pytest.mark.parametrize("test_mode,scene_classes", [(False, False),
                                                     (False, True),
                                                     (True, False)])
def test_nyu_dataset_matches_jax(tree, test_mode, scene_classes):
    """Infos (sorted, the `None` pair dropped in training), every field of
    every sample, the GT (PNG / 1000) and the scene classes in sorted
    filename order; the split given relative to data_root."""
    split = "splits/nyu_test.txt" if test_mode else "splits/nyu_train.txt"
    port, ref = _datasets(tree, split, test_mode, scene_classes)
    assert port.infos == ref.infos
    assert len(port) == len(ref) == (3 if test_mode else 3 * (FRAMES - 1))
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["img"].dtype == np.float32 and got["img"].shape == (
            480, 640, 3)
        assert float(got["cam_height"]) == 0.0
        np.testing.assert_array_equal(port.load_gt(i), ref.load_gt(i))
    if scene_classes:
        assert port.scene_class_names == ref.scene_class_names == [
            "bedroom", "kitchen"]
        assert [port[i]["scene_class"] for i in range(len(port))] == [
            0] * 4 + [1] * 2


def test_nyu_split_rules(tree, tmp_path):
    """A `None` pair is kept in test mode and dropped in training; an
    absolute split path is read as it is, and a split line whose names
    begin with '/' names files from the root of the file system, in both
    packages (the JAX `_abs`)."""
    root = tree["root"]
    lines = [f"{root}/bedroom_0004/rgb_00001.png "
             f"{root}/bedroom_0004/sync_depth_00001.png 518.8579",
             "kitchen_0011/rgb_00000.png None 518.8579"]
    split = tmp_path / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    for test_mode in (False, True):
        port, ref = _datasets(tree, str(split), test_mode)
        assert port.infos == ref.infos
        assert len(port) == (2 if test_mode else 1)
        absolute = [i for i, info in enumerate(port.infos)
                    if info["depth_map"] is not None][0]
        np.testing.assert_array_equal(port[absolute]["img"],
                                      ref[absolute]["img"])
        np.testing.assert_array_equal(port.load_gt(absolute),
                                      ref.load_gt(absolute))


def _cfgs(crop=(416, 544)):
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu_torch.configs import get_config

    jcfg = jax_get_config("adabins_nyu")
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, crop_size=crop))
    tcfg = get_config("adabins_nyu")
    return tcfg.replace(data=dataclasses.replace(tcfg.data,
                                                 crop_size=crop)), jcfg


def test_nyu_train_chain_matches_jax(tree):
    """NYUCrop -> RandomRotate -> RandomFlip -> RandomCrop(416, 544) ->
    ColorAug -> Normalize over 12 seeds: the same sample, and the same
    draws consumed; rotated RGB frames of 3 channels."""
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.data.nyu import NYUDataset

    tcfg, jcfg = _cfgs()
    port = build_train_pipeline(tcfg.data, tcfg.model.depth_scale)
    ref = jax_chain(jcfg)
    ds = NYUDataset(tree["root"], "splits/nyu_train.txt")
    rotated = 0
    for seed in range(12):
        sample = ds[seed % len(ds)]
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = port(_copy(sample), rt), ref(_copy(sample), rj)
        assert rt.bit_generator.state == rj.bit_generator.state, seed
        _assert_same(got, want)
        assert got["img"].shape == (416, 544, 3)
        rotated += np.random.default_rng(seed).random() < 0.5
    assert 0 < rotated < 12


def test_nyu_test_chain_is_the_jax_fall_through(tree):
    """The JAX evaluator has no NYU branch: normalisation at the frame's
    own size (480x640), no crop to eval_size."""
    from gedepth_tpu.eval.evaluator import build_test_pipeline as jax_test
    from gedepth_tpu_torch.data import build_test_pipeline
    from gedepth_tpu_torch.data.nyu import NYUDataset

    tcfg, jcfg = _cfgs()
    ds = NYUDataset(tree["root"], "splits/nyu_test.txt", test_mode=True)
    sample = ds[0]
    got = build_test_pipeline(tcfg.data)(_copy(sample))
    want = jax_test(jcfg.data)(_copy(sample), np.random.default_rng(0))
    assert got["img"].shape == (480, 640, 3)
    _assert_same(got, want)


def test_nyu_loader_batches_match_jax(tree):
    """TrainLoader batches of 2 with scene classes (crop 416x544): every
    key, `scene_class` included, as the JAX loader's."""
    from gedepth_tpu.data.extra_datasets import NYUDataset as JaxNYU
    from gedepth_tpu.data.loader import TrainLoader as JaxLoader
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.nyu import NYUDataset

    tcfg, jcfg = _cfgs()
    split = "splits/nyu_train.txt"
    loader = TrainLoader(NYUDataset(tree["root"], split, scene_classes=True),
                         build_train_pipeline(tcfg.data), 2, seed=5)
    ref = JaxLoader(JaxNYU(tree["root"], split, scene_classes=True),
                    jax_chain(jcfg), 2, seed=5)
    for step in range(2):
        got, want = loader.make_batch(step), ref._make_batch(step)
        assert sorted(got) == sorted(want)
        assert "scene_class" in got and got["img"].shape == (2, 416, 544, 3)
        for key in want:
            if key == "img":
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=1e-3)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


def test_nyu_eval_crop_is_the_jax_fractional_eigen_crop(tree):
    """The evaluator's mask on an NYU GT (eigen crop, no garg crop, range
    (1e-3, 10)) equals the JAX package's."""
    from gedepth_tpu.core.metrics import eval_crop_mask as jax_mask
    from gedepth_tpu_torch.core.metrics import eval_crop_mask
    from gedepth_tpu_torch.data.nyu import NYUDataset

    tcfg, _ = _cfgs()
    gt = NYUDataset(tree["root"], "splits/nyu_test.txt",
                    test_mode=True).load_gt(0)
    kw = dict(garg_crop=tcfg.data.garg_crop, eigen_crop=tcfg.data.eigen_crop)
    got = eval_crop_mask(gt, 1e-3, 10.0, **kw)
    np.testing.assert_array_equal(got, jax_mask(gt, 1e-3, 10.0, **kw))
    assert got.any() and not got[:100].any()


def test_jpeg_frames_through_pil(tree, tmp_path):
    """A JPEG frame (by its magic bytes, whatever its name) decodes through
    PIL as the JAX dataset decodes it; the datasets agree on a tree of
    JPEG frames."""
    pytest.importorskip("PIL")
    from PIL import Image

    from gedepth_tpu_torch.utils.png import read_rgb

    root = str(tmp_path / "jpeg")
    shutil.copytree(tree["root"], root)
    lines = []
    with open(osp.join(root, "splits", "nyu_test.txt")) as f:
        split = f.read().splitlines()
    for line in split:
        img, depth, focal = line.split()
        jpg = img.replace(".png", ".jpg")
        Image.open(osp.join(root, img)).save(osp.join(root, jpg),
                                             quality=90)
        lines.append(f"{jpg} {depth} {focal}")
    with open(osp.join(root, "splits", "nyu_test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    port, ref = _datasets(dict(root=root), "splits/nyu_test.txt")
    for i in range(len(ref)):
        np.testing.assert_array_equal(port[i]["img"], ref[i]["img"])
    path = osp.join(root, lines[0].split()[0])
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(read_rgb(data), port[0]["img"])


def test_jpeg_without_pil_names_the_file(tree, tmp_path, monkeypatch):
    """Where PIL does not import, a JPEG of a kind the port's decoder does
    not read (progressive) raises ImportError naming the file, the kind
    and PIL; a baseline JPEG and a PNG still read."""
    from gedepth_tpu_torch.tools.make_jpeg_fixtures import DEFAULT_DIR
    from gedepth_tpu_torch.utils.png import read_rgb

    path = tmp_path / "frame.png"          # a JPEG under a PNG's name
    with open(osp.join(DEFAULT_DIR, "progressive.jpg"), "rb") as f:
        path.write_bytes(f.read())
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError,
                       match="frame.png: a progressive JPEG.*PIL"):
        read_rgb(str(path))
    assert read_rgb(osp.join(DEFAULT_DIR, "sunrgbd_0.jpg")).shape == (
        530, 730, 3)
    png = osp.join(tree["root"], "bedroom_0004", "rgb_00000.png")
    assert read_rgb(png).shape == (480, 640, 3)


def test_make_tree_cli_writes_nyu(tmp_path, capsys):
    from gedepth_tpu_torch.tools.make_tree import main

    main(["nyu", str(tmp_path), "--frames", "1", "--size", "480,640"])
    out = capsys.readouterr().out
    assert "nyu_train.txt" in out and "nyu_test.txt" in out
    scenes = sorted(d for d in os.listdir(tmp_path) if d != "splits")
    assert scenes == ["bedroom_0004", "bedroom_0017", "kitchen_0011"]
    assert sorted(os.listdir(tmp_path / "bedroom_0004")) == [
        "rgb_00000.png", "sync_depth_00000.png"]


def test_adabins_nyu_trains_and_evaluates_from_the_tree(tree, tmp_path,
                                                        capsys):
    """tools.train `adabins_nyu` (b0, head 8, 16 bins, crop 128x192, batch
    2) from the NYU tree for 2 steps with an evaluation on the test split
    at the frames' 480x640; then tools.test of its best `.npz`, and
    `inference_depther` on an RGB frame's path (no plane embedding asked
    for: NYU frames carry none)."""
    from gedepth_tpu_torch.apis import inference_depther, init_depther
    from gedepth_tpu_torch.configs import apply_options, get_config
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.tools import train as train_cli

    opts = [f"data.data_root={tree['root']}", "data.crop_size=(128,192)",
            "train.global_batch=2", "train.eval_interval=2",
            "train.checkpoint_interval=2", "train.log_interval=1",
            "optim.warmup_iters=1", "model.head_channels=8",
            "model.n_bins=16"]
    work = tmp_path / "run"
    train_cli.main(["adabins_nyu", "--device", "cpu", "--work-dir",
                    str(work), "--max-iters", "2", "--eval-max-images", "1",
                    "--options", *opts])
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert best["iter"] == 2 and np.isfinite(best["abs_rel"])
    npz = str(work / "best_abs_rel.npz")
    test_cli.main(["adabins_nyu", npz, "--device", "cpu", "--max-images",
                   "1", "--options", *opts])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["images"] == 1 and np.isfinite(line["rmse"])
    frame = osp.join(tree["root"], "kitchen_0011", "rgb_00002.png")
    handle = init_depther(apply_options(get_config("adabins_nyu"), opts),
                          device="cpu", checkpoint=npz)
    depth = inference_depther(handle, frame)
    assert depth.shape == (480, 640) and np.isfinite(depth).all()
    assert depth.min() >= 1e-3 and depth.max() <= 10.0
