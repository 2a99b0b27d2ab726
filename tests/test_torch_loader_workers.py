"""The port's loaders against the JAX package's, and their worker processes.

`TrainLoader._index_for` equals the JAX loader's for both sampling rules,
one and two shards and steps across epoch boundaries; each shard's batches
equal its rows of the JAX loader's; the stream of batches is byte for byte
the same with 0 and 2 workers (synthetic frames, and a KITTI tree whose
PNG decode runs in the workers); `EvalLoader`'s shards partition the
dataset as the JAX loader's do; a worker that dies fails the stream;
`TrainConfig.num_workers` and `sampling` reach the train loop through
`--options`, and two workers train exactly as one thread does;
`tools.bench_loader` reports a rate. Everything at smoke sizes on one torch
thread.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gedepth_tpu_torch.configs import apply_options, get_config
from gedepth_tpu_torch.data import (
    EvalLoader, SyntheticGroundDataset, TrainLoader, build_train_pipeline)
from gedepth_tpu_torch.data.loader import PREFETCH

torch.set_num_threads(1)

CROP = (32, 64)


def _data():
    return dataclasses.replace(get_config("smoke_synthetic").data,
                               crop_size=CROP)


def _dataset(size=5):
    return SyntheticGroundDataset(size=size, height=48, width=96)


def _jax_loader(global_batch, shard_index, shard_count, sampling, size=5):
    from gedepth_tpu.configs import get_config as jax_get_config
    from gedepth_tpu.data.loader import TrainLoader as JaxLoader
    from gedepth_tpu.data.synthetic import SyntheticGroundDataset as JaxDS
    from gedepth_tpu.train.loop import build_train_pipeline as jax_pipeline

    jcfg = jax_get_config("smoke_synthetic")
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, crop_size=CROP))
    return JaxLoader(JaxDS(size=size, height=48, width=96),
                     jax_pipeline(jcfg), global_batch, seed=7,
                     shard_index=shard_index, shard_count=shard_count,
                     sampling=sampling)


@pytest.mark.parametrize("sampling", ["epoch", "replacement"])
@pytest.mark.parametrize("shard_count", [1, 2])
def test_index_for_matches_jax(sampling, shard_count):
    for shard in range(shard_count):
        want = _jax_loader(4, shard, shard_count, sampling)
        got = TrainLoader(_dataset(), None, 4, seed=7, shard_index=shard,
                          shard_count=shard_count, sampling=sampling)
        assert got.local_batch == want.local_batch == 4 // shard_count
        for step in range(12):          # 48 slots over a set of 5
            for slot in range(4):
                assert got._index_for(step, slot) == want._index_for(
                    step, slot), (step, slot)


def _assert_batches_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=f"{key} {what}")


@pytest.mark.parametrize("sampling", ["epoch", "replacement"])
@pytest.mark.parametrize("shard_count", [1, 2])
def test_worker_stream_matches_jax_rows(sampling, shard_count):
    """Each shard's stream with 0 and with 2 workers, byte for byte the
    JAX loader's rows of the same batches."""
    steps = 3
    for shard in range(shard_count):
        want = _jax_loader(4, shard, shard_count, sampling)
        for workers in (0, 2):
            loader = TrainLoader(_dataset(), build_train_pipeline(_data()), 4,
                                 seed=7, shard_index=shard,
                                 shard_count=shard_count, num_workers=workers,
                                 sampling=sampling)
            stream = iter(loader)
            try:
                for step in range(steps):
                    batch = next(stream)
                    assert all(torch.is_tensor(v) for v in batch.values())
                    _assert_batches_equal(
                        batch, want._make_batch(step),
                        f"step {step} shard {shard} workers {workers}")
            finally:
                stream.close()


def test_loader_arguments_are_checked():
    with pytest.raises(ValueError, match="divide"):
        TrainLoader(_dataset(), None, 3, shard_count=2)
    with pytest.raises(ValueError, match="sampling"):
        TrainLoader(_dataset(), None, 2, sampling="stratified")
    with pytest.raises(ValueError, match="shard"):
        TrainLoader(_dataset(), None, 2, shard_index=2, shard_count=2)


@pytest.mark.parametrize("shard_count", [1, 2, 3])
def test_eval_shards_partition_the_dataset(shard_count):
    from gedepth_tpu.data.loader import EvalLoader as JaxEvalLoader

    ds = SyntheticGroundDataset(size=7, height=16, width=32, seed=1)
    seen = []
    for shard in range(shard_count):
        got = EvalLoader(ds, lambda s, rng: s, 2, shard, shard_count)
        want = JaxEvalLoader(ds, lambda s, rng: s, 2, shard_index=shard,
                             shard_count=shard_count)
        assert len(got) == len(want)
        pairs = list(zip(got, want))
        assert len(pairs) == len(got)
        for (batch, valid), (jbatch, jvalid) in pairs:
            np.testing.assert_array_equal(valid, jvalid)
            _assert_batches_equal(batch, jbatch, f"shard {shard}")
            seen += [int(i) for i in batch["index"][valid]]
    assert sorted(seen) == list(range(7))


class _DiesAtTwo:
    """A dataset whose worker process exits at index 2."""

    def __init__(self):
        self.base = _dataset()

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i == 2:
            os._exit(3)
        return self.base[i]


def test_a_dying_worker_fails_the_stream():
    loader = TrainLoader(_DiesAtTwo(), build_train_pipeline(_data()), 1,
                         seed=0, num_workers=2, sampling="replacement")
    order = [loader._index_for(s, 0) for s in range(8)]
    assert 2 in order
    stream = iter(loader)
    with pytest.raises(RuntimeError, match="worker"):
        for _ in range(8):
            next(stream)
    stream.close()


def test_kitti_tree_stream_with_workers(tmp_path):
    """PNG decode and the KITTI chain in two workers (the library built
    once, before they start): the same batches as one thread."""
    from gedepth_tpu_torch.tools import preprocess_data_kitti
    from gedepth_tpu_torch.tools.make_tree import make_kitti_tree
    from gedepth_tpu_torch.train.loop import build_train_dataset

    root = str(tmp_path / "kitti")
    splits = make_kitti_tree(root, size=(120, 400), frames=2, seed=2)
    preprocess_data_kitti.main(["--data-root", root, "--split",
                                splits["train"], "--workers", "1"])
    cfg = apply_options(get_config("smoke_synthetic"), [
        "data.dataset=kitti", f"data.data_root={root}",
        f"data.train_split={splits['train']}", "data.crop_size=(64,128)"])
    streams = []
    for workers in (0, 2):
        loader = TrainLoader(build_train_dataset(cfg),
                             build_train_pipeline(cfg.data, 200.0), 2,
                             seed=1, num_workers=workers)
        stream = iter(loader)
        try:
            streams.append([next(stream) for _ in range(2)])
        finally:
            stream.close()
    for a, b in zip(*streams):
        _assert_batches_equal(a, {k: v.numpy() for k, v in b.items()},
                              "kitti")


class _RecordingLoader(TrainLoader):
    """A TrainLoader that notes its worker count and sampling rule (at
    module level: the workers unpickle it)."""
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made.append((self.num_workers, self.sampling))


def test_train_config_reaches_the_loop(monkeypatch):
    """`train.num_workers` and `train.sampling` through --options; two
    workers give the losses one thread gives, bit for bit."""
    import gedepth_tpu_torch.train.loop as loop

    made = []
    monkeypatch.setattr(loop, "TrainLoader", _RecordingLoader)
    monkeypatch.setattr(_RecordingLoader, "made", made)
    base = get_config("smoke_synthetic")
    assert (base.train.num_workers, base.train.sampling) == (0, "epoch")
    assert get_config("gedepth_adaptive_kitti").train.num_workers == 4
    losses = []
    for workers in (0, 2):
        cfg = apply_options(base, [
            f"train.num_workers={workers}", "train.sampling=replacement",
            "data.crop_size=(64,128)", "data.eval_size=(64,128)",
            "data.synthetic_size=4", "train.eval_interval=100"])
        _, history, _ = loop.train(cfg, max_iters=2, eval_max_images=1,
                                   device="cpu")
        losses.append([r["loss"] for r in history if r["mode"] == "train"])
    assert made == [(0, "replacement"), (2, "replacement")]
    assert losses[0] == losses[1]


def test_bench_loader_reports_rates(capsys):
    from gedepth_tpu_torch.tools import bench_loader

    loader = TrainLoader(_dataset(), build_train_pipeline(_data()), 2,
                         seed=0)
    rate, kept = bench_loader.loader_rate(loader, steps=2, keep=2)
    assert rate["samples_per_s"] > 0 and rate["first_batch_s"] > 0
    # the first batch and the PREFETCH the thread had queued stay outside
    # the window, which by default holds four times what is in flight
    assert rate["warm_batches"] == 1 + PREFETCH
    assert rate["window_batches"] == 2
    assert bench_loader.window_batches(loader) == max(16, 4 * PREFETCH)
    assert len(kept) == 2
    bench_loader.main(["smoke_synthetic", "--workers", "0", "--steps", "2",
                       "--step-ms", "250", "--options",
                       "data.crop_size=(32,64)"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workers"] == 0 and line["global_batch"] == 2
    assert line["need_samples_per_s"] == pytest.approx(8.0)
    assert line["keeps_up"] == (line["samples_per_s"] >= 8.0)


_STOP_SCRIPT = """
import dataclasses, json, os
import torch
torch.set_num_threads(1)
from gedepth_tpu_torch.configs import get_config
from gedepth_tpu_torch.data import (
    SyntheticGroundDataset, TrainLoader, build_train_pipeline)
from gedepth_tpu_torch.data.loader import stop_worker_server


def children():
    me, found = str(os.getpid()), []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[1] == me and fields[0] != "Z":
            found.append(int(entry))
    return found


data = dataclasses.replace(get_config("smoke_synthetic").data,
                           crop_size=(32, 64))
loader = TrainLoader(SyntheticGroundDataset(size=4, height=48, width=96),
                     build_train_pipeline(data), 2, seed=0, num_workers=2)
stream = iter(loader)
next(stream)
stream.close()
closed = children()
stop_worker_server()
stopped = children()
stream = iter(loader)       # a later loader starts the server again
next(stream)
stream.close()
stop_worker_server()
print(json.dumps({"closed": closed, "stopped": stopped,
                  "again": children()}))
"""


def test_stop_worker_server_leaves_no_process():
    """A closed loader leaves the forkserver and the resource tracker
    running as this process's children; `stop_worker_server` stops both,
    and a later loader works and is stopped the same way. In a process of
    its own, whose children are only the loader's."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _STOP_SCRIPT],
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(got["closed"]) == 2, got     # forkserver, resource tracker
    assert got["stopped"] == [] and got["again"] == [], got
