"""`SegEvaluator` in two processes of the port (gloo on the CPU) against
one process, in the style of tests/test_torch_distributed.py: the seg
preset's model (HRNet-W18, head_channels 8, seeded) over 3 synthetic
ground scenes at 64x128 (shards of 2 and 1 images). Its counts are
integers summed over the processes, so every rank's miou, acc and
iou_cls0/1 equal the one process's exactly, and so does the image count.

The ranks are this file run as a script in two subprocesses with
torchrun's environment, each with its own timeout, on one torch thread.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gedepth_tpu_torch import parallel  # noqa: E402

H, W = 64, 128
IMAGES = 3
WORKER_TIMEOUT = 300          # seconds, each rank

torch.set_num_threads(1)


def seg_eval():
    """The SegEvaluator's aggregate and image count, sharded by the process
    group when there is one."""
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data import SyntheticGroundDataset
    from gedepth_tpu_torch.eval import SegEvaluator

    cfg = get_config("ocrnet_hr18_kitti")
    model = dataclasses.replace(cfg.model, head_channels=8).build(
        generator=torch.Generator().manual_seed(0))
    data = dataclasses.replace(get_config("smoke_synthetic").data,
                               eval_size=(H, W))
    evaluator = SegEvaluator(model, SyntheticGroundDataset(
        size=IMAGES, height=H, width=W, seed=1), data)
    agg, rows = evaluator.run()
    return {"agg": agg, "rows": rows, "images": evaluator.images,
            "world": parallel.world()}


def _worker(out):
    parallel.init_from_env("cpu")
    try:
        Path(out.format(rank=parallel.rank())).write_text(
            json.dumps(seg_eval()))
    finally:
        parallel.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, started first, then the one-process reference while
    they run."""
    tmp = tmp_path_factory.mktemp("seg_ranks")
    out = str(tmp / "rank{rank}.json")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        one = seg_eval()
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return one, [json.loads(Path(out.format(rank=r)).read_text())
                 for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_seg_evaluator_equals_one_process(runs, rank):
    one, ranks = runs
    got = ranks[rank]
    assert one["world"] == 1 and got["world"] == 2
    assert one["images"] == got["images"] == IMAGES
    assert got["rows"] == one["rows"] == []
    assert list(got["agg"]) == ["miou", "acc", "iou_cls0", "iou_cls1"]
    assert got["agg"] == one["agg"]
    assert 0 < one["agg"]["acc"] < 1


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(sys.argv[1])
