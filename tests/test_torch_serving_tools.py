"""The port's serving tools on the CPU: `utils.color_depth`,
`tools.inference`, `tools.test --show-dir / --format-only` and
`tools.export --self-check`, at smoke width.

`colorize_depth` is held byte for byte against the JAX package's, which
renders with matplotlib; the PNGs the tools write are read back with
`utils.png.read_png` and held to the prediction they came from exactly.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from gedepth_tpu.utils.color_depth import colorize_depth as jax_colorize
from gedepth_tpu_torch.utils.color_depth import MAGMA_R, colorize_depth
from gedepth_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(1)


def _depths():
    rng = np.random.default_rng(0)
    with_nan = rng.uniform(0.5, 1.0, (20, 24)).astype(np.float32)
    with_nan[3, 4] = with_nan[7, 0] = np.nan
    return {
        "uniform": (rng.uniform(1, 80, (30, 40)).astype(np.float32), {}),
        "ramp_edges": (np.linspace(0, 1, 1024, dtype=np.float32).reshape(
            8, 128), {}),
        "constant": (np.full((5, 6), 7.5, np.float32), {}),
        "zeros": (np.zeros((4, 4), np.float32), {}),
        "nan_pixels": (with_nan, {}),
        "all_nan": (np.full((3, 3), np.nan, np.float32), {}),
        "vmin_vmax": (rng.uniform(1, 80, (16, 16)).astype(np.float32),
                      dict(vmin=10.0, vmax=50.0)),
        "float64": (rng.uniform(1e-3, 80, (16, 16)), {}),
    }


@pytest.mark.parametrize("case", sorted(_depths()))
def test_colorize_depth_equals_jax(case):
    depth, kw = _depths()[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # nanmin of an all-NaN map
        want = jax_colorize(depth, **kw)
        got = colorize_depth(depth, **kw)
    assert got.dtype == np.uint8 and got.shape == depth.shape + (3,)
    np.testing.assert_array_equal(got, want)


def test_magma_table_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps["magma_r"]
    want = (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(MAGMA_R, want)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A params-only `.npz` of the seeded smoke model (seed 4)."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.train.checkpoint import save_params_only

    model = get_config("smoke_synthetic").model.build(
        generator=torch.Generator().manual_seed(4))
    path = str(tmp_path_factory.mktemp("weights") / "smoke.npz")
    save_params_only(path, model)
    return path


def test_inference_tool(npz, tmp_path, capsys):
    """`tools.inference` on a seeded PNG with --pe and --npy: the `.npy`
    is `inference_depther`'s depth, the PNG its colourised render."""
    from gedepth_tpu_torch.apis.inference import (
        inference_depther, init_depther)
    from gedepth_tpu_torch.tools import inference

    rng = np.random.default_rng(1)
    png, pe = tmp_path / "frame_7.png", tmp_path / "pe.npy"
    write_png(png, rng.integers(0, 256, (64, 128, 3), dtype=np.uint8))
    np.save(pe, rng.uniform(2.0, 150.0, (64, 128)).astype(np.float32))
    out = tmp_path / "out"
    inference.main(["smoke_synthetic", npz, str(png), "--pe", str(pe),
                    "--cam-height", "1.6", "--out-dir", str(out), "--npy",
                    "--device", "cpu"])
    assert "frame_7_depth.png" in capsys.readouterr().out
    depth = np.load(out / "frame_7_depth.npy")
    handle = init_depther("smoke_synthetic", device="cpu", checkpoint=npz,
                          pe_path=str(pe))
    want = inference_depther(handle, str(png), cam_height=1.6)
    np.testing.assert_array_equal(depth, want)
    assert depth.shape == (64, 128) and np.isfinite(depth).all()
    np.testing.assert_array_equal(read_png(out / "frame_7_depth.png"),
                                  colorize_depth(depth))


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    from gedepth_tpu_torch.tools import preprocess_data_kitti
    from gedepth_tpu_torch.tools.make_tree import make_kitti_tree

    root = str(tmp_path_factory.mktemp("kitti"))
    splits = make_kitti_tree(root, size=(120, 400), frames=2, seed=5)
    preprocess_data_kitti.main(["--data-root", root, "--split",
                                splits["train"], "--workers", "1"])
    return root, splits


def test_test_tool_show_and_format(npz, kitti_tree, tmp_path, capsys):
    """`tools.test --show-dir --format-only` on a KITTI tree: one uint16
    PNG per image that reads back as the prediction × gt_depth_scale,
    clipped to 0..65535 and truncated, and one colour PNG that equals
    `colorize_depth` of the prediction; no metrics."""
    from gedepth_tpu_torch.configs import apply_options, get_config
    from gedepth_tpu_torch.eval import Evaluator
    from gedepth_tpu_torch.tools import test as test_cli
    from gedepth_tpu_torch.train.checkpoint import load_params_only
    from gedepth_tpu_torch.train.loop import build_eval_dataset

    root, splits = kitti_tree
    options = ["data.dataset=kitti", f"data.data_root={root}",
               f"data.test_split={splits['test']}",
               "data.eval_size=(96,320)", "data.eval_flip_tta=False"]
    show, fmt = tmp_path / "show", tmp_path / "fmt"
    test_cli.main(["smoke_synthetic", npz, "--device", "cpu", "--show-dir",
                   str(show), "--format-only", "--format-dir", str(fmt),
                   "--options", *options])
    assert "wrote formatted predictions" in capsys.readouterr().out

    cfg = apply_options(get_config("smoke_synthetic"), options)
    model = cfg.model.build()
    load_params_only(npz, model)
    dataset = build_eval_dataset(cfg)
    preds = {}
    Evaluator(model.eval(), dataset, cfg.data).run(
        on_prediction=lambda i, p: preds.setdefault(i, p),
        compute_metrics=False)
    assert len(preds) == len(dataset) == 2
    names = sorted(os.listdir(fmt))
    assert sorted(os.listdir(show)) == [n[:-4] + "_depth.png" for n in names]
    for index, pred in preds.items():
        stem = test_cli.output_stem(dataset, index)
        assert stem == os.path.splitext(
            dataset.infos[index]["filename"].replace("/", "_"))[0]
        out16 = read_png(fmt / f"{stem}.png")
        assert out16.dtype == np.uint16 and out16.shape == (96, 320)
        np.testing.assert_array_equal(
            out16, np.clip(pred * 256.0, 0, 65535).astype(np.uint16))
        np.testing.assert_array_equal(read_png(show / f"{stem}_depth.png"),
                                      colorize_depth(pred))


def test_test_tool_show_dir_with_metrics(tmp_path, capsys):
    """--show-dir alone keeps the metrics: the JSON line and one render per
    synthetic frame."""
    from gedepth_tpu_torch.tools import test as test_cli

    test_cli.main(["smoke_synthetic", "--device", "cpu", "--max-images",
                   "2", "--no-tta", "--show-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["images"] == 2 and np.isfinite(line["abs_rel"])
    assert sorted(os.listdir(tmp_path)) == [
        "synthetic_00000_depth.png", "synthetic_00001_depth.png"]


def test_export_tool_self_check(npz, tmp_path, capsys):
    """`tools.export --self-check`: the artifact's three files, the port's
    ops in its program, and the reloaded program equal to the eager step
    on the seeded batch."""
    from gedepth_tpu_torch.tools import export

    out = tmp_path / "art"
    export.main(["smoke_synthetic", npz, "--output", str(out), "--height",
                 "64", "--width", "128", "--no-flip-tta", "--self-check",
                 "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(os.listdir(out)) == ["meta.json", "model.pt2",
                                       "weights.pt"]
    assert line["ops"] == ["gedepth_torch::msda", "gedepth_torch::pe_fusion",
                           "gedepth_torch::window_attention"]
    assert line["img"] == [1, 64, 128, 5] and line["finite"]
    assert line["max_abs_diff"] == 0.0
    assert line["bytes"] == sum(os.path.getsize(out / f)
                                for f in os.listdir(out))
    with pytest.raises(SystemExit):
        export.main(["smoke_synthetic", "--output", str(out), "--height",
                     "64"])


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("tool", ["export", "inference"])
def test_serving_tools_switch_tf32_off(monkeypatch, tmp_path, tool):
    """As every CLI of the port: TF32 off for matmuls and convolutions
    before the work, whatever the process had set (the work stubbed)."""
    import gedepth_tpu_torch.apis.export as export_api
    import gedepth_tpu_torch.apis.inference as inference_api
    from gedepth_tpu_torch.tools import export, inference

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    class Stop(Exception):
        pass

    def stub(*args, **kwargs):
        seen.append(_flags())
        raise Stop

    if tool == "export":
        monkeypatch.setattr(export_api, "export_depther", stub)
        argv = ["smoke_synthetic", "--output", str(tmp_path)]
        cli = export
    else:
        monkeypatch.setattr(inference_api, "init_depther", stub)
        argv = ["smoke_synthetic", "w.npz", "x.png"]
        cli = inference
    with pytest.raises(Stop):
        cli.main(argv + ["--device", "cpu"])
    assert seen == [(False, False)]
