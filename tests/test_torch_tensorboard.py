"""The port's TensorBoard logging and the train record's `time` against the
JAX package, on the CPU.

`utils.tensorboard.TensorboardLogger` and `gedepth_tpu.utils.tensorboard.
TensorboardLogger` (tf.summary) take the same dicts; both event files are
read back with tensorboard's own loader and must hold the same tags, steps,
plugins and values (scalars as float32 bytes, images as the same width,
height and pixels). The train loop writes every number of each written
record under `train/` or `val/`, and a written train record's `time` spans
the log_interval steps since the previous one, as the JAX loop's does; the
JAX and the port's `cal_train_time` print the same line for that file.
"""
import contextlib
import dataclasses
import glob
import io
import json
import os
import sys

import numpy as np
import torch

from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.utils.png import read_png
from gedepth_tpu_torch.utils.tensorboard import TensorboardLogger

torch.set_num_threads(1)


def _events(log_dir):
    """(tag, step, plugin, value) of every summary value in `log_dir`'s
    event files: a float for a scalar, (width, height, pixels) for an
    image."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.*"))):
        for event in EventFileLoader(path).Load():
            for v in event.summary.value:
                plugin = v.metadata.plugin_data.plugin_name
                if plugin == "scalars":
                    value = float(tensor_util.make_ndarray(v.tensor))
                else:
                    w, h, png = v.tensor.string_val
                    value = (int(w), int(h), read_png(png).tolist())
                out.append((v.tag, event.step, plugin, value))
    return out


DICTS = [
    (3, {"loss": 1.5, "loss_depth": np.float32(1.25), "iter": 3,
         "lr": 9.999870798083066e-08, "time": 0.204, "mode": "train"},
     "train/"),
    (4, {"abs_rel": 0.999035656452179, "a1": 0.0, "images": 2,
         "iter": 4, "mode": "val"}, "val/"),
]


def test_scalars_match_the_jax_logger(tmp_path):
    from gedepth_tpu.utils.tensorboard import TensorboardLogger as JaxLogger

    jax_logger = JaxLogger(str(tmp_path / "jax"))
    port = TensorboardLogger(str(tmp_path / "port"))
    assert jax_logger.active and port.active
    for step, values, prefix in DICTS:
        jax_logger.scalars(step, values, prefix=prefix)
        port.scalars(step, values, prefix=prefix)
    port.close()
    want = _events(str(tmp_path / "jax"))
    got = _events(str(tmp_path / "port"))
    assert got == want
    assert ("train/lr", 3, "scalars", float(np.float32(9.999870798083066e-08))
            ) in got
    assert not any(tag.endswith("/mode") for tag, *_ in got)


def test_triptych_matches_the_jax_logger(tmp_path):
    from gedepth_tpu.utils.tensorboard import TensorboardLogger as JaxLogger

    rng = np.random.default_rng(0)
    rgb = rng.uniform(-20, 280, (12, 20, 3))
    pred = rng.uniform(1, 80, (12, 20))
    gt = np.where(rng.random((12, 20)) < 0.5, 0.0, pred + 1)
    jax_logger = JaxLogger(str(tmp_path / "jax"))
    port = TensorboardLogger(str(tmp_path / "port"))
    for logger in (jax_logger, port):
        logger.depth_triptych(7, rgb, pred, gt, tag="val")
        logger.depth_triptych(8, rgb, pred, None, tag="show")
    port.close()
    want = _events(str(tmp_path / "jax"))
    got = _events(str(tmp_path / "port"))
    assert [g[:3] for g in got] == [
        ("val/rgb", 7, "images"), ("val/pred", 7, "images"),
        ("val/gt", 7, "images"), ("show/rgb", 8, "images"),
        ("show/pred", 8, "images")]
    assert got == want


def test_logger_is_a_no_op_without_tensorboard(tmp_path, monkeypatch):
    for name in [k for k in sys.modules if k.split(".")[0] == "tensorboard"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    logger = TensorboardLogger(str(tmp_path / "tb"))
    assert not logger.active
    logger.scalars(1, {"loss": 1.0})
    logger.depth_triptych(1, np.zeros((2, 2, 3)), np.ones((2, 2)))
    logger.close()
    assert not (tmp_path / "tb").exists()


def _zoo_cfg(**train_over):
    """densedepth_kitti at tiny widths on synthetic 64x128 frames."""
    cfg = get_config("densedepth_kitti")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, head_channels=8,
                                  backbone_variant="18"),
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 crop_size=(64, 128), eval_size=(64, 128),
                                 synthetic_size=4, eval_flip_tta=False),
        train=dataclasses.replace(cfg.train, global_batch=1, num_workers=0,
                                  **train_over))


def _records(work):
    return [json.loads(line) for line in
            (work / "train.log.jsonl").read_text().splitlines()]


def test_train_record_time_spans_its_log_interval(tmp_path):
    """4 steps at log_interval 2: the written records at iters 2 and 4, each
    with the seconds since the previous written record (the loop's start
    for the first), so at least its two steps' own seconds; the JAX and
    port `cal_train_time` print the same line for the file."""
    from gedepth_tpu_torch.tools import analyze_logs as port_tool
    from gedepth_tpu_torch.train.loop import train
    import tools.analyze_logs as jax_tool

    work = tmp_path / "run"
    cfg = _zoo_cfg(log_interval=2, eval_interval=100)
    _, history, _ = train(cfg, work_dir=str(work), max_iters=4,
                          eval_max_images=1, device="cpu")
    steps = {r["iter"]: r["time"] for r in history if r["mode"] == "train"}
    written = [r for r in _records(work) if r["mode"] == "train"]
    assert [r["iter"] for r in written] == [2, 4]
    for r in written:
        block = steps[r["iter"] - 1] + steps[r["iter"]]
        assert r["time"] >= round(block, 3) - 1e-3, (r, block)
        assert r["time"] == round(r["time"], 3)

    lines = []
    for run in (lambda: jax_tool.cal_train_time(
                    type("A", (), {"logs": [str(work / "train.log.jsonl")]})),
                lambda: port_tool.cal_train_time(
                    [str(work / "train.log.jsonl")])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run()
        lines.append(out.getvalue())
    assert lines[0] == lines[1] and "mean iter-block time" in lines[0]


def test_train_writes_tensorboard_events(tmp_path):
    """Every number of every written record, at its iter, under train/ or
    val/ in work_dir/tb, with the record's value in float32."""
    from gedepth_tpu_torch.train.loop import train

    work = tmp_path / "run"
    train(_zoo_cfg(log_interval=1, eval_interval=2), work_dir=str(work),
          max_iters=2, eval_max_images=1, device="cpu")
    got = {(tag, step): value
           for tag, step, plugin, value in _events(str(work / "tb"))}
    want = {}
    for r in _records(work):
        if r["mode"] in ("train", "val"):
            for k, v in r.items():
                if isinstance(v, (int, float)):
                    want[(f"{r['mode']}/{k}", r["iter"])] = float(
                        np.float32(v))
    assert got == want
    assert ("train/loss", 1) in got and ("val/abs_rel", 2) in got
