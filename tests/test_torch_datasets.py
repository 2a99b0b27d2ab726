"""The port's KITTI and DDAD datasets, calibration, plane embeddings, slope
rules and preprocessing tools against the JAX package, on the CPU.

Trees in the datasets' layouts are written by `tools.make_tree` into a
temporary directory: KITTI with two dates of different frame sizes and a
`None` pair, DDAD with two cameras and a split line of a third that the
dataset filters out. The port's preprocessing tools and the JAX package's
(tools/preprocess_data_*.py) run on twin trees; their outputs, and every
field of every sample the two datasets serve, are equal exactly (the same
numpy arithmetic on the same decoded pixels).
"""
import os.path as osp
import shutil

import numpy as np
import pytest

from gedepth_tpu_torch.tools.make_tree import make_ddad_tree, make_kitti_tree

KITTI_SIZE = (120, 400)
DDAD_SIZE = (152, 242)


def _preprocess(kind, root, splits, port):
    if kind == "kitti":
        if port:
            from gedepth_tpu_torch.tools.preprocess_data_kitti import main
            main(["--data-root", root, "--split", splits["train"],
                  "--workers", "1"])
        else:
            from tools.preprocess_data_kitti import (
                precompute_pe, precompute_slope)
            precompute_pe(root)
            precompute_slope(root, splits["train"], 1)
    elif port:
        from gedepth_tpu_torch.tools.preprocess_data_ddad import main
        main(["--data-root", root, "--calib-npz", splits["calib"],
              "--split", splits["train"], "--workers", "1"])
    else:
        # the JAX tool's slope stage maps `_slope_one` over a process pool;
        # its tasks are mapped here in this process instead (no fork of a
        # process that runs JAX)
        from tools.preprocess_data_ddad import (
            CAMERAS, _slope_one, precompute_pe_from_npz)
        precompute_pe_from_npz(root, splits["calib"])
        with open(splits["train"]) as f:
            for line in f:
                depth = line.split()[1]
                if depth.split("/")[-2] in CAMERAS:
                    _slope_one((root, depth.replace("depth_val", "depth")))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{kind: (root, splits)}: trees finished by the port's tools, and
    their twins finished by the JAX package's tools."""
    out = {}
    for kind, make, size in (("kitti", make_kitti_tree, KITTI_SIZE),
                             ("ddad", make_ddad_tree, DDAD_SIZE)):
        for port in (True, False):
            root = str(tmp_path_factory.mktemp(f"{kind}_{port}"))
            splits = make(root, size=size, frames=3, seed=1)
            _preprocess(kind, root, splits, port)
            out[(kind, port)] = root, splits
    return out


def _files(root, suffixes):
    import glob
    return sorted(osp.relpath(p, root)
                  for s in suffixes
                  for p in glob.glob(osp.join(root, "**", "*" + s),
                                     recursive=True))


@pytest.mark.parametrize("kind", ["kitti", "ddad"])
def test_preprocessing_matches_jax_tools(trees, kind):
    (proot, _), (jroot, _) = trees[(kind, True)], trees[(kind, False)]
    made = _files(proot, (".npy", "_slope_public_debug.npz")) + [
        f for f in _files(proot, (".npz",))
        if "slope_range" in f or "pe_public" in f]
    assert made == _files(jroot, (".npy", "_slope_public_debug.npz")) + [
        f for f in _files(jroot, (".npz",))
        if "slope_range" in f or "pe_public" in f]
    assert len(made) >= 4
    for rel in made:
        a, b = np.load(osp.join(proot, rel)), np.load(osp.join(jroot, rel))
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(a, b, err_msg=rel)
        else:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=rel)
    if kind == "kitti":
        shapes = {np.load(osp.join(proot, f)).shape for f in made
                  if f.endswith(".npy")}
        assert shapes == {KITTI_SIZE, (KITTI_SIZE[0] - 5,
                                       KITTI_SIZE[1] - 18)}


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "filename":
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("use_pe", [True, False])
def test_kitti_dataset_matches_jax(trees, test_mode, use_pe):
    from gedepth_tpu.data import KittiDataset as JaxKitti
    from gedepth_tpu_torch.data import KittiDataset

    root, splits = trees[("kitti", True)]
    split = splits["test" if test_mode else "train"]
    kw = dict(test_mode=test_mode, use_pe=use_pe)
    got, want = KittiDataset(root, split, **kw), JaxKitti(root, split, **kw)
    assert len(got) == len(want) == (2 if test_mode else 4)
    assert got.invalid_depth_num == want.invalid_depth_num == (
        2 if test_mode else 0)
    assert [i["filename"] for i in got.infos] == sorted(
        i["filename"] for i in got.infos)
    sizes = set()
    for i in range(len(got)):
        a, b = got[i], want[i]
        _assert_samples_equal(a, b)
        np.testing.assert_array_equal(got.load_gt(i), want.load_gt(i))
        sizes.add(a["img"].shape)
        assert ("depth_gt" in a) != test_mode
        assert ("pe_k_gt" in a) != test_mode    # the slope GT is trained on
    assert len(sizes) == 2                  # two dates, two frame sizes


def test_kitti_slope_resized_to_the_gt(trees, tmp_path):
    """A slope `.npz` of another shape is resized nearest to the GT."""
    from gedepth_tpu.data import KittiDataset as JaxKitti
    from gedepth_tpu_torch.data import KittiDataset

    root, splits = trees[("kitti", True)]
    copy = str(tmp_path / "kitti")
    shutil.copytree(root, copy)
    ds = KittiDataset(copy, splits["train"])
    slope = ds.gt_path(0).replace(".png", ".npz").replace(
        "gt_depth", "slope_range_5_5_interval_1")
    k = np.load(slope)["k_img"]
    np.savez_compressed(slope, k_img=k[::2, ::3])
    _assert_samples_equal(ds[0], JaxKitti(copy, splits["train"])[0])
    assert ds[0]["pe_k_gt"].shape == ds.load_gt(0).shape


@pytest.mark.parametrize("test_mode", [False, True])
def test_ddad_dataset_matches_jax(trees, test_mode):
    from gedepth_tpu.data import DDADDataset as JaxDDAD
    from gedepth_tpu_torch.data import DDADDataset

    root, splits = trees[("ddad", True)]
    split = splits["test" if test_mode else "train"]
    got = DDADDataset(root, split, test_mode=test_mode)
    want = JaxDDAD(root, split, test_mode=test_mode)
    with open(split) as f:
        assert sum("CAMERA_07" in line for line in f) == 1
    assert len(got) == len(want) == (2 if test_mode else 4)
    assert all("CAMERA_07" not in i["depth_map"] and "depth_val" not in
               i["depth_map"] for i in got.infos)
    heights = set()
    for i in range(len(got)):
        _assert_samples_equal(got[i], want[i])
        np.testing.assert_array_equal(got.load_gt(i), want.load_gt(i))
        heights.add(float(got[i]["cam_height"]))
    assert heights == {np.float32(1.56), np.float32(1.57)}
    cams = DDADDataset(root, split, cameras=("CAMERA_05",))
    assert len(cams) == len(got) // 2


def test_wrappers_match_jax(trees):
    from gedepth_tpu.data.wrappers import ConcatDataset as JaxConcat
    from gedepth_tpu.data.wrappers import RepeatDataset as JaxRepeat
    from gedepth_tpu_torch.data import (
        ConcatDataset, KittiDataset, RepeatDataset)

    root, splits = trees[("kitti", True)]
    a = KittiDataset(root, splits["train"])
    b = KittiDataset(root, splits["train"], use_pe=False)
    rep, jrep = RepeatDataset(a, 3), JaxRepeat(a, 3)
    cat, jcat = ConcatDataset([a, b]), JaxConcat([a, b])
    assert len(rep) == len(jrep) == 12 and len(cat) == len(jcat) == 8
    for i in (0, 5, 11):
        _assert_samples_equal(rep[i], jrep[i])
        np.testing.assert_array_equal(rep.load_gt(i), jrep.load_gt(i))
    for i in (1, 4, 7):
        _assert_samples_equal(cat[i], jcat[i])
        assert cat[i]["index"] == i
        np.testing.assert_array_equal(cat.load_gt(i), jcat.load_gt(i))


def test_calibration_matches_jax(trees):
    from gedepth_tpu.geometry import calib as jcalib
    from gedepth_tpu_torch.geometry import calib as tcalib

    root, _ = trees[("kitti", True)]
    date_dir = osp.join(root, "input", "2011_09_28")
    got = tcalib.parse_kitti_calib(
        osp.join(date_dir, "calib_cam_to_cam.txt"),
        osp.join(date_dir, "calib_velo_to_cam.txt"))
    want = jcalib.parse_kitti_calib(
        osp.join(date_dir, "calib_cam_to_cam.txt"),
        osp.join(date_dir, "calib_velo_to_cam.txt"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tcalib.kitti_projection_matrix(date_dir),
                                  jcalib.kitti_projection_matrix(date_dir))
    assert tcalib.KITTI_CAMERA_HEIGHT == jcalib.KITTI_CAMERA_HEIGHT
    assert tcalib.KITTI_CAM_INTRINSICS_4COL == jcalib.KITTI_CAM_INTRINSICS_4COL
    assert tcalib.DDAD_CAMERA_HEIGHTS == jcalib.DDAD_CAMERA_HEIGHTS
    for date, m in jcalib.KITTI_CAM_INTRINSICS_3x3.items():
        np.testing.assert_array_equal(tcalib.KITTI_CAM_INTRINSICS_3x3[date],
                                      m)
    from gedepth_tpu.data.ddad import DDAD_CAM_INTRINSICS_4COL, DDAD_CAMERAS
    from gedepth_tpu_torch.data import ddad as tddad
    assert tddad.DDAD_CAMERAS == DDAD_CAMERAS
    assert tddad.DDAD_CAM_INTRINSICS_4COL == DDAD_CAM_INTRINSICS_4COL


def test_plane_embeddings_and_slope_rules_match_jax():
    from gedepth_tpu.geometry import plane as jplane
    from gedepth_tpu_torch.geometry import plane as tplane
    from gedepth_tpu_torch.tools.make_tree import ddad_calibration

    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (3, 4)) + np.eye(3, 4) * 500
    np.testing.assert_array_equal(
        tplane.kitti_plane_embedding(A, 30, 50),
        jplane.kitti_plane_embedding(A, 30, 50))
    calib = ddad_calibration((40, 64))
    for cam in ("CAMERA_01", "CAMERA_09"):
        args = (calib[f"{cam}_K"], calib[f"{cam}_cam_pose"],
                calib[f"{cam}_lidar_pose"], 40, 64)
        pe = tplane.ddad_plane_embedding(*args)
        np.testing.assert_array_equal(pe, jplane.ddad_plane_embedding(*args))
        assert (pe[-1] > 0).all()           # the bottom row sees the ground
    # GT zeros (NaN-free ignore), negative and huge priors, both rules
    pe = rng.uniform(-50, 150, (40, 64))
    pe[0, :5] = 0.0
    gt = np.abs(pe) * rng.uniform(0.8, 1.25, pe.shape)
    gt[rng.random(gt.shape) < 0.4] = 0.0
    for rounding in ("round", "trunc"):
        got = tplane.slope_bin_gt(gt, pe, 1.53, rounding=rounding)
        np.testing.assert_array_equal(
            got, jplane.slope_bin_gt(gt, pe, 1.53, rounding=rounding))
        assert set(np.unique(got)) <= set(range(-5, 6)) | {255}
    a, b = (tplane.slope_bin_gt(gt, pe, 1.53, rounding=r)
            for r in ("round", "trunc"))
    assert (a != b).any()
    with pytest.raises(ValueError):
        tplane.slope_bin_gt(gt, pe, rounding="floor")


@pytest.mark.parametrize("dataset", ["kitti", "ddad"])
def test_missing_root_or_split_raises(trees, tmp_path, dataset):
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.train.loop import (
        build_datasets, build_eval_dataset, build_train_dataset)

    root, splits = trees[(dataset, True)]
    cfg = get_config(f"gedepth_adaptive_{dataset}")
    good = cfg.replace(data=dataclasses.replace(
        cfg.data, data_root=root, train_split=splits["train"],
        test_split=splits["test"], repeat_times=2))
    train, test = build_datasets(good)
    assert len(train) == 8 and len(test) == 2
    missing = str(tmp_path / "nowhere")
    for over, fn in ((dict(data_root=missing), build_train_dataset),
                     (dict(train_split=missing), build_train_dataset),
                     (dict(test_split=missing), build_eval_dataset)):
        bad = good.replace(data=dataclasses.replace(good.data, **over))
        with pytest.raises(FileNotFoundError, match="nowhere"):
            fn(bad)
