"""The port's generic tools against the JAX package's, on the CPU:
`tools.print_config`, `tools.analyze_logs`, `tools.ensemble`,
`tools.visualize_point_cloud`, and `--options` in
`tools.convert_torch_checkpoint`.

Each JAX tool runs its own `main` on the same arguments (PIL and matplotlib
are here); the outputs must be equal: the JSON of the shared fields, the
printed line, the PNG pixels (read back with `utils.png.read_png`) and the
PLY text. None of the port's tools needs PIL or matplotlib; the plots say
so and stop where matplotlib does not import.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.utils.png import read_png

torch.set_num_threads(1)


def _run_jax_tool(module, argv, monkeypatch):
    """stdout of the JAX tool `module`'s main on `argv`."""
    out = io.StringIO()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [module.__file__] + list(argv))
        with contextlib.redirect_stdout(out):
            module.main()
    return out.getvalue()


def _run_port_tool(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["bts_kitti"],
    ["densedepth_kitti", "--options", "model.head_channels=8",
     "data.crop_size=(64,128)", "optim.max_lr=2e-4"],
    ["gedepth_adaptive_kitti_tpu", "--options", "train.log_interval=2"],
])
def test_print_config_matches_jax(argv, monkeypatch):
    """Every field the port has equals the JAX tool's; the JAX fields the
    port lacks are the ones `LEFT_OUT` lists."""
    import tools.print_config as jax_tool
    from gedepth_tpu_torch.tools import print_config
    from test_torch_gedepth import LEFT_OUT

    want = json.loads(_run_jax_tool(jax_tool, argv, monkeypatch))
    got = json.loads(_run_port_tool(print_config.main, argv))
    assert {k: got[k] for k in ("name", "work_dir")} == {
        k: want[k] for k in ("name", "work_dir")}
    for part in ("model", "data", "optim", "train"):
        assert set(want[part]) - set(got[part]) == LEFT_OUT[part], part
        assert got[part] == {k: want[part][k] for k in got[part]}, part


def _log(path, times):
    with open(path, "w") as f:
        f.write(json.dumps({"mode": "env", "torch": "x"}) + "\n")
        for i, t in enumerate(times):
            f.write(json.dumps({"mode": "train", "iter": 10 * (i + 1),
                                "loss": 1.0 / (i + 1), "time": t}) + "\n")
            f.write(json.dumps({"mode": "val", "iter": 10 * (i + 1),
                                "abs_rel": 0.1, "time": 9.0}) + "\n")


def test_cal_train_time_matches_jax(tmp_path, monkeypatch):
    import tools.analyze_logs as jax_tool
    from gedepth_tpu_torch.tools import analyze_logs

    logs = [str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl"),
            str(tmp_path / "c.jsonl")]
    _log(logs[0], [2.5, 1.2345, 1.3, 0.9995])
    _log(logs[1], [4.0])
    _log(logs[2], [])
    argv = ["cal_train_time"] + logs
    want = _run_jax_tool(jax_tool, argv, monkeypatch)
    got = _run_port_tool(analyze_logs.main, argv)
    assert got == want
    assert got.splitlines()[2].endswith("no train records")


def test_plot_curve(tmp_path, monkeypatch, capsys):
    """With matplotlib: the PNG; without: a message and status 1."""
    from gedepth_tpu_torch.tools import analyze_logs

    log = str(tmp_path / "a.jsonl")
    _log(log, [1.0, 2.0])
    out = str(tmp_path / "c.png")
    assert analyze_logs.main(["plot_curve", log, "--keys", "loss",
                              "abs_rel", "--out", out]) == 0
    assert read_png(out).ndim == 3
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert analyze_logs.main(["plot_curve", log, "--out",
                              str(tmp_path / "d.png")]) == 1
    assert "matplotlib" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "d.png")


@pytest.mark.parametrize("weights", [None, ["0.25", "0.75"]])
def test_ensemble_matches_jax(weights, tmp_path, monkeypatch):
    """The same uint16 pixels as the JAX tool's PIL PNGs, clipped at 0 and
    65535."""
    import tools.ensemble as jax_tool
    from gedepth_tpu_torch.tools import ensemble

    rng = np.random.default_rng(0)
    dirs = [tmp_path / "a", tmp_path / "b"]
    for d in dirs:
        d.mkdir()
        for name in ("x_0", "x_1"):
            depth = rng.uniform(-5, 300, (6, 9)).astype(np.float32)
            depth[0, :2] = (-1.0, 300.0)       # past both ends of uint16
            np.save(d / f"{name}.npy", depth)
    args = ["--inputs", *map(str, dirs), "--scale", "256"]
    if weights:
        args += ["--weights", *weights]
    want = _run_jax_tool(jax_tool, args + ["--out", str(tmp_path / "j")],
                         monkeypatch)
    got = _run_port_tool(ensemble.main, args + ["--out",
                                                str(tmp_path / "p")])
    assert got.split(" to ")[0] == want.split(" to ")[0]
    assert sorted(os.listdir(tmp_path / "p")) == ["x_0.png", "x_1.png"]
    for name in ("x_0.png", "x_1.png"):
        p, j = read_png(tmp_path / "p" / name), read_png(tmp_path / "j" / name)
        assert p.dtype == j.dtype == np.uint16
        np.testing.assert_array_equal(p, j)
        assert p.max() == 65535 and p.min() == 0


def test_point_cloud_ply_matches_jax(tmp_path):
    import tools.visualize_point_cloud as jax_tool
    from gedepth_tpu_torch.geometry.calib import KITTI_CAM_INTRINSICS_3x3
    from gedepth_tpu_torch.tools import visualize_point_cloud as port_tool

    rng = np.random.default_rng(1)
    depth = rng.uniform(1, 80, (12, 20)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0
    K = KITTI_CAM_INTRINSICS_3x3["2011_09_26"]
    jax_tool.write_ply(tmp_path / "j.ply", jax_tool.backproject(depth, K))
    port_tool.write_ply(tmp_path / "p.ply", port_tool.backproject(depth, K))
    text = (tmp_path / "p.ply").read_text()
    assert text == (tmp_path / "j.ply").read_text()
    assert f"element vertex {int((depth > 0).sum())}" in text


def test_visualize_point_cloud_cli(tmp_path, monkeypatch, capsys):
    """A tiny bts model on synthetic frames: the pred and PE clouds of two
    images, and the render, then the same without matplotlib (PLYs only,
    with a message)."""
    from gedepth_tpu_torch.tools import visualize_point_cloud as tool

    argv = ["bts_kitti", "--device", "cpu", "--indices", "0", "1",
            "--out-dir", str(tmp_path / "pc"), "--render", "--options",
            "data.dataset=synthetic", "data.eval_size=(64,128)",
            "data.synthetic_size=8", "model.head_channels=8",
            "model.backbone_variant=18"]
    tool.main(argv)
    assert sorted(os.listdir(tmp_path / "pc")) == [
        "00000.png", "00000_pe.ply", "00000_pred.ply", "00001.png",
        "00001_pe.ply", "00001_pred.ply"]
    head = (tmp_path / "pc" / "00000_pred.ply").read_text().splitlines()
    assert head[0] == "ply" and head[2] == f"element vertex {64 * 128}"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tool.main(argv[:5] + ["--out-dir", str(tmp_path / "pc2")] + argv[8:])
    assert sorted(os.listdir(tmp_path / "pc2")) == ["00000_pe.ply",
                                                    "00000_pred.ply"]
    assert "needs matplotlib" in capsys.readouterr().out


def test_convert_torch_checkpoint_options_on_a_zoo_preset(tmp_path,
                                                          capsys):
    """`--options` sizes the preset's model; a reference-named BTS `.pth`
    gives it its decode head, the stem keys are reported unused and the
    ResNet's layers unmapped, as the JAX converter leaves them."""
    from gedepth_tpu_torch.models.resnet import ResNet
    from gedepth_tpu_torch.tools import convert_torch_checkpoint as tool
    from gedepth_tpu_torch.train.checkpoint import load_params_only
    from gedepth_tpu_torch.configs import apply_options, get_config
    from test_torch_bts_textbook import TBTSHead

    torch.manual_seed(0)
    backbone = ResNet(18, include_stem=True)
    head = TBTSHead(backbone.channels, 128, 80.0, 1e-3)
    sd = {f"decode_head.{k}": v for k, v in head.state_dict().items()}
    sd.update({f"backbone.{k}": v for k, v in backbone.state_dict().items()})
    torch.save(sd, tmp_path / "bts.pth")
    options = ["model.backbone_variant=18", "model.head_channels=32"]
    report = tool.main([str(tmp_path / "bts.pth"), "bts_kitti",
                        str(tmp_path / "out.npz"), "--options", *options])
    out = capsys.readouterr().out
    assert "torch keys map to modules this model lacks" in out
    assert report["unused_torch_keys"][-1] == "backbone.conv1.weight"
    assert all(k.startswith("backbone.layer")
               for k in report["unmapped_torch_keys"])
    cfg = apply_options(get_config("bts_kitti"), options)
    model = load_params_only(str(tmp_path / "out.npz"), cfg.model.build())
    got = model.state_dict()
    for k, v in head.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[f"decode_head.{k}"], v), k
    assert cfg.model.head_channels == 32
