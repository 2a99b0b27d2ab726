"""The port's SUN RGB-D, Cityscapes, nuScenes and custom datasets
(`data.extra_datasets`) against the JAX package's classes on the CPU, on
`tools.make_tree` trees at small sizes (Cityscapes 64x128; the JPEG trees
at the fixtures' 45x80 and 53x73; a custom folder of a PNG, a .jpg and a
.JPG): infos, RGB and GT bit for bit in train and test mode, Cityscapes'
camera path from either split form, the train chain's output for seeded
draws (rotated RGB within 1e-3, as tests/test_torch_nyu.py holds it), the
test chain, `build_datasets` dispatch for all four names, and what the
evaluator does on a folder without GT: it raises KeyError('depth_gt') when
asked for metrics and writes predictions under --format-only, as the JAX
`Evaluator` does.
"""
import dataclasses
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.tools import make_tree

from test_torch_transforms_cv2 import _assert_same, _copy

torch.set_num_threads(1)

SIZES = {"cityscapes": (64, 128), "nuscenes": (45, 80),
         "sunrgbd": (53, 73), "custom": (48, 64)}
CROPS = {"cityscapes": (48, 96), "nuscenes": (32, 64), "sunrgbd": (32, 48),
         "custom": (32, 48)}
CLASSES = {"cityscapes": "CityscapesDataset", "nuscenes": "NuScenesDataset",
           "sunrgbd": "SUNRGBDDataset", "custom": "CustomDepthDataset"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, size in SIZES.items():
        root = str(tmp_path_factory.mktemp(name))
        frames = {"cityscapes": 2, "nuscenes": 3, "sunrgbd": 2}.get(name)
        kw = {"frames": frames} if frames else {}
        out[name] = dict(make_tree.WRITERS[name](root, size=size, seed=4,
                                                 **kw), root=root)
    return out


def _classes(name):
    from gedepth_tpu.data import extra_datasets as jax_extra
    from gedepth_tpu_torch.data import extra_datasets as port_extra

    return getattr(port_extra, CLASSES[name]), getattr(jax_extra,
                                                        CLASSES[name])


def _pair(trees, name, test_mode):
    port_cls, jax_cls = _classes(name)
    root = trees[name]["root"]
    if name == "custom":
        return port_cls(root), jax_cls(root)
    split = trees[name]["test" if test_mode else "train"]
    return (port_cls(root, split, test_mode=test_mode),
            jax_cls(root, split, test_mode=test_mode))


@pytest.mark.parametrize("name,test_mode", [
    (n, t) for n in ("cityscapes", "nuscenes", "sunrgbd") for t in (False,
                                                                   True)]
    + [("custom", True)])
def test_dataset_matches_jax(trees, name, test_mode):
    port, ref = _pair(trees, name, test_mode)
    assert port.infos == ref.infos and len(port) == len(ref) > 0
    for attr in ("depth_scale", "min_depth", "max_depth", "garg_crop",
                 "eigen_crop", "test_mode"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(
                want[key]).dtype, key
        assert got["img"].shape[-1] == 3 and float(got["cam_height"]) == 0
        if name != "custom":
            gt, gt_ref = port.load_gt(i), ref.load_gt(i)
            assert gt.dtype == gt_ref.dtype == np.float32
            np.testing.assert_array_equal(gt, gt_ref)
            assert (gt > 0).any()
    assert not hasattr(port, "scene_classes") or name != "sunrgbd"


def test_custom_folder_lists_images_by_suffix(trees):
    port, _ = _pair(trees, "custom", True)
    assert [i["filename"] for i in port.infos] == trees["custom"]["frames"]
    assert port[1]["img"].shape == (530, 730, 3)      # the SUN RGB-D JPEG
    assert port[2]["img"].shape == (61, 83, 3)        # the .JPG


def test_cityscapes_camera_from_either_split_form(trees, tmp_path):
    """A line with the camera column and one without read the same GT; the
    depth is baseline·fx / ((png − 1)/256) in float32 with png <= 0 at 0,
    bit for bit as the JAX package computes it."""
    from gedepth_tpu_torch.data.extra_datasets import CityscapesDataset
    from gedepth_tpu_torch.utils.png import read_png

    root = trees["cityscapes"]["root"]
    with open(trees["cityscapes"]["train"]) as f:
        lines = f.read().split()
    img, disp, cam = lines[:3]
    assert cam.endswith("_camera.json")
    split = tmp_path / "two.txt"
    split.write_text(f"{img} {disp} {cam}\n{img} {disp}\n")
    ds = CityscapesDataset(root, str(split))
    assert ds.camera_path(0) == ds.camera_path(1) == osp.join(root, cam)
    np.testing.assert_array_equal(ds.load_gt(0), ds.load_gt(1))
    png = read_png(osp.join(root, disp)).astype(np.float32)
    with open(osp.join(root, cam)) as f:
        camera = json.load(f)
    bf = np.float32(camera["extrinsic"]["baseline"]
                    * camera["intrinsic"]["fx"])
    want = np.where(png > 0, bf / np.where(png > 0, (png - 1) / 256, 1), 0)
    np.testing.assert_array_equal(ds.load_gt(0), want.astype(np.float32))
    assert (png == 0).any() and (png > 0).any()


def _cfgs(name, trees):
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu_torch.configs import get_config

    t = trees[name]
    data = dict(dataset=name, data_root=t["root"],
                train_split=t.get("train", ""), test_split=t.get("test", ""),
                crop_size=CROPS[name])
    jcfg, tcfg = jax_get_config("smoke_synthetic"), get_config(
        "smoke_synthetic")
    return (tcfg.replace(data=dataclasses.replace(tcfg.data, **data)),
            jcfg.replace(data=dataclasses.replace(jcfg.data, **data)))


@pytest.mark.parametrize("name", ["cityscapes", "nuscenes", "sunrgbd",
                                  "custom"])
def test_train_chain_matches_jax(trees, name):
    """RandomRotate -> RandomFlip -> RandomCrop -> ColorAug -> Normalize
    over 8 seeds: the same sample, the same draws consumed."""
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import build_train_pipeline

    tcfg, jcfg = _cfgs(name, trees)
    port_chain = build_train_pipeline(tcfg.data, tcfg.model.depth_scale)
    ref_chain = jax_chain(jcfg)
    port, _ = _pair(trees, name, name == "custom")
    for seed in range(8):
        sample = port[seed % len(port)]
        if sample["img"].shape[0] < CROPS[name][0]:
            continue                            # the 61x83 .JPG is smaller
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = port_chain(_copy(sample), rt), ref_chain(_copy(sample),
                                                             rj)
        assert rt.bit_generator.state == rj.bit_generator.state, seed
        _assert_same(got, want)
        assert got["img"].shape == CROPS[name] + (3,)


@pytest.mark.parametrize("name", ["cityscapes", "nuscenes", "sunrgbd",
                                  "custom"])
def test_test_chain_and_dispatch_match_jax(trees, name):
    """`build_datasets` builds the JAX loop's classes over the same infos
    (custom: the folder for both splits); the test chain normalises at the
    frame's own size, as the JAX evaluator's fall-through does."""
    from gedepth_tpu.eval.evaluator import build_test_pipeline as jax_test
    from gedepth_tpu.train.loop import build_datasets as jax_build
    from gedepth_tpu_torch.data import build_test_pipeline
    from gedepth_tpu_torch.train.loop import build_datasets

    tcfg, jcfg = _cfgs(name, trees)
    got, want = build_datasets(tcfg), jax_build(jcfg)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == CLASSES[name]
        assert g.infos == w.infos and g.test_mode == w.test_mode
        assert g.depth_scale == w.depth_scale
    sample = got[1][0]
    a = build_test_pipeline(tcfg.data)(_copy(sample))
    b = jax_test(jcfg.data)(_copy(sample), np.random.default_rng(0))
    assert a["img"].shape == sample["img"].shape
    _assert_same(a, b)


def _evaluators(trees):
    """The port's and the JAX package's Evaluator over the custom folder,
    each with an eval step that predicts 1 m everywhere."""
    from gedepth_tpu.eval.evaluator import Evaluator as JaxEvaluator
    from gedepth_tpu.data import CustomDepthDataset as JaxCustom
    from gedepth_tpu_torch.data import CustomDepthDataset
    from gedepth_tpu_torch.eval import Evaluator

    tcfg, jcfg = _cfgs("custom", trees)
    root = trees["custom"]["root"]
    port = Evaluator(tcfg.model.build(device="cpu").eval(),
                     CustomDepthDataset(root), tcfg.data)
    port.eval_steps = [lambda img, ch: torch.ones(img.shape[:3])]
    ref = JaxEvaluator(jcfg.model.build(), JaxCustom(root), jcfg.data,
                       process_index=0, process_count=1)
    ref.eval_steps = [lambda params, stats, batch: np.ones(
        batch["img"].shape[:3], np.float32)]
    return port, ref


def test_evaluator_without_gt_as_jax(trees):
    """Metrics asked for on a folder without GT: KeyError('depth_gt') in
    both packages; compute_metrics=False (--format-only): every frame's
    prediction at its own size, no metrics."""
    port, ref = _evaluators(trees)
    with pytest.raises(KeyError, match="depth_gt"):
        ref.run({}, {})
    with pytest.raises(KeyError, match="depth_gt"):
        port.run()
    seen = {"port": [], "jax": []}
    agg, rows = port.run(compute_metrics=False, on_prediction=lambda i, p:
                         seen["port"].append((i, p.shape)))
    ragg, rrows = ref.run({}, {}, compute_metrics=False,
                          on_prediction=lambda i, p:
                          seen["jax"].append((i, p.shape)))
    assert (agg, rows) == (ragg, rrows) == ({}, [])
    assert seen["port"] == seen["jax"] == [(0, (48, 64)), (1, (530, 730)),
                                           (2, (61, 83))]


@pytest.mark.parametrize("name", ["cityscapes", "nuscenes", "sunrgbd",
                                  "custom"])
def test_make_tree_cli_writes_each_dataset(name, tmp_path, capsys):
    size = ",".join(str(v) for v in SIZES[name])
    make_tree.main([name, str(tmp_path), "--size", size])
    out = capsys.readouterr().out
    files = [osp.relpath(osp.join(d, f), tmp_path)
             for d, _, fs in os.walk(tmp_path) for f in fs]
    if name == "custom":
        assert sorted(files) == ["frame_a.png", "frame_b.jpg", "frame_c.JPG",
                                 "notes.txt"]
        return
    assert "train:" in out and "test:" in out
    suffix = {"cityscapes": "_leftImg8bit.png"}.get(name, ".jpg")
    assert any(f.endswith(suffix) for f in files)
    if name == "cityscapes":
        assert any(f.endswith("_camera.json") for f in files)
        assert any(f.endswith("_disparity.png") for f in files)


def test_jpeg_trees_take_the_fixtures_sizes_only(tmp_path):
    with pytest.raises(ValueError, match=r"\(45, 80\).*not \(40, 80\)"):
        make_tree.make_nuscenes_tree(str(tmp_path), size=(40, 80))


@pytest.mark.parametrize("name", ["cityscapes", "nuscenes"])
def test_loader_batches_match_jax(trees, name):
    """TrainLoader batches of 2 over the tree (the extra datasets' chain):
    every key as the JAX loader's, the rotated RGB within 1e-3."""
    from gedepth_tpu.data.loader import TrainLoader as JaxLoader
    from gedepth_tpu.train.loop import build_train_pipeline as jax_chain
    from gedepth_tpu_torch.data import build_train_pipeline
    from gedepth_tpu_torch.data.loader import TrainLoader

    tcfg, jcfg = _cfgs(name, trees)
    port, ref = _pair(trees, name, False)
    loader = TrainLoader(port, build_train_pipeline(tcfg.data), 2, seed=7)
    jloader = JaxLoader(ref, jax_chain(jcfg), 2, seed=7)
    for step in range(2):
        got, want = loader.make_batch(step), jloader._make_batch(step)
        assert sorted(got) == sorted(want)
        assert got["img"].shape == (2,) + CROPS[name] + (3,)
        for key in want:
            if key == "img":
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=1e-3)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
