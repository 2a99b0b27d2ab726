"""Loader throughput: does the host make batches as fast as the card takes
them? (The counterpart of tools/bench_loader.py.)

    python -m gedepth_tpu_torch.tools.bench_loader <preset>
        [--workers 0,2,4] [--steps N] [--global-batch B] [--step-ms MS]
        [--options key=value ...]

Times `TrainLoader` over the preset's train split and train chain (a KITTI
or DDAD tree under data.data_root, such as `tools.make_tree` writes and the
preprocessing tools finish, or synthetic frames) at each worker count: the
samples a second over `--steps` batches (by default four times the batches
in flight, at least 16), timed after the first batch and the batches in
flight when it came (max(1, workers) x PREFETCH: they were made while the
workers started, so a window that held them would read high), and the wait
for the first batch.
`--step-ms` is a measured train-step time at that global batch; the rate a
card needs is then global batch / step time, and each line says whether the
loader keeps up. One JSON line per worker count. Host clock only: these are
the host's numbers, whatever the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

from gedepth_tpu_torch.data.loader import (
    PREFETCH, TrainLoader, stop_worker_server)


def warm_batches(loader) -> int:
    """Batches taken before the timed window: the first and those in
    flight when it comes (PREFETCH a worker, or PREFETCH queued by the one
    thread)."""
    return 1 + max(1, loader.num_workers) * PREFETCH


def window_batches(loader) -> int:
    """Batches timed: four times those in flight, so the work the workers
    have in hand when the window opens adds at most ~1/16 to it; at least
    16."""
    return max(16, 4 * (warm_batches(loader) - 1))


def loader_rate(loader, steps: int | None = None, keep: int = 0):
    """Run `loader` (a `TrainLoader`) for `warm_batches` + `steps`
    (default `window_batches`) batches, timing the last `steps`; returns
    ({samples_per_s, first_batch_s, warm_batches, window_batches}, the
    first `keep` batches)."""
    steps = steps or window_batches(loader)
    kept, warm = [], warm_batches(loader)
    with contextlib.closing(iter(loader)) as batches:
        t0 = time.perf_counter()
        for i in range(warm + steps):
            if i == warm:
                t1 = time.perf_counter()
            batch = next(batches)
            if i == 0:
                first = time.perf_counter() - t0
            if len(kept) < keep:
                kept.append(batch)
        window = time.perf_counter() - t1
    samples = steps * loader.local_batch
    return ({"samples_per_s": samples / window, "first_batch_s": first,
             "warm_batches": warm, "window_batches": steps}, kept)


def main(argv=None):
    from gedepth_tpu_torch.configs import (
        apply_options, get_config, list_configs)

    parser = argparse.ArgumentParser(description="TrainLoader throughput")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--workers", default="0,2,4")
    parser.add_argument("--steps", type=int, default=None,
                        help="batches timed after the warm ones (default: "
                        "four times those in flight, at least 16)")
    parser.add_argument("--global-batch", type=int, default=None)
    parser.add_argument("--step-ms", type=float, default=None,
                        help="a measured train-step time at this batch")
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.loop import build_train_dataset

    cfg = apply_options(get_config(args.config), args.options)
    batch = args.global_batch or cfg.train.global_batch
    dataset = build_train_dataset(cfg)
    pipeline = build_train_pipeline(cfg.data, cfg.model.depth_scale)
    need = batch / (args.step_ms / 1e3) if args.step_ms else None
    try:
        for w in (int(v) for v in args.workers.split(",")):
            rate, _ = loader_rate(TrainLoader(
                dataset, pipeline, batch, seed=cfg.train.seed, num_workers=w,
                sampling=cfg.train.sampling), args.steps)
            line = dict(rate, config=cfg.name, dataset=cfg.data.dataset,
                        workers=w, global_batch=batch)
            if need is not None:
                line.update(step_ms=args.step_ms, need_samples_per_s=need,
                            keeps_up=rate["samples_per_s"] >= need)
            print(json.dumps(line), flush=True)
    finally:
        stop_worker_server()


if __name__ == "__main__":
    main()
