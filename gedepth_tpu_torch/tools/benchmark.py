"""Timing CLI of the port (the counterpart of tools/benchmark.py): warm-up
iterations, then timed iterations of `predict_depth` or of the train step.

    python -m gedepth_tpu_torch.tools.benchmark <preset> [--iters 200]
        [--warmup 5] [--batch 1] [--height 352] [--width 1216]
        [--train-step] [--bf16] [--no-autotuner] [--trace-dir DIR]
        [--device cuda]

The input is the JAX tool's: `default_rng(0).standard_normal`, channel 4
(the raw PE) as |x|·30 + 1. Serving times `GEDepth.predict_depth`; a preset
with a `bf16_scope` has that scope's weights cast once, and `--bf16` casts
the whole model once and the input per call. `--train-step` times the
port's train step on that batch (depth_gt = |channel 0|·10, slope class 0),
with `--bf16` as `TrainConfig.bf16_compute`; cuDNN's autotuner is on as in
`train()` (`--no-autotuner` leaves the choice to cuDNN's heuristic, which
picks FFT algorithms for some f32 convolutions), and the first step, which
carries its search, runs before the warm-up and outside the timed window.

TF32 is switched off for matmuls and convolutions, so an f32 run is f32.
On a CUDA device every iteration is timed with CUDA events (the device's
time from the iteration's first kernel to its last, the gaps between kernels
included) and the whole loop on a synchronised host clock; after the timed
loop `torch.profiler` reads the summed kernel durations of single iterations
(`device_busy_ms`: the gaps left out). Before the summary line one JSON line
gives the preset, shape, batch, dtype or scope, iterations, the median,
minimum and maximum of the per-iteration device time, the host-clock ms per
iteration, the busy time, the device-idle share (1 − busy / host; from the
event times where the profiler saw nothing, `idle_from` says which), the
peak device memory and the card's name and power limit. On the CPU only the
host clock is read and the device fields are null. `--trace-dir` writes a
`torch.profiler` chrome trace of the timed loop.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import time


def card_name_and_limit():
    """`nvidia-smi`'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def benchmark_input(pe_variant, batch, height, width, device):
    """The JAX tool's input (B, H, W, 5|3) as a tensor on `device`."""
    import numpy as np
    import torch

    c = 5 if pe_variant != "none" else 3
    img = np.random.default_rng(0).standard_normal(
        (batch, height, width, c)).astype(np.float32)
    if c == 5:
        img[..., 4] = np.abs(img[..., 4]) * 30 + 1.0
    return torch.from_numpy(img).to(device)


@dataclasses.dataclass
class Runner:
    """One thing to time: `run()` is an iteration (a `predict_depth` call or
    a train step on the benchmark batch), `context` what must be entered
    around it (cuDNN's autotuner for training)."""
    run: object
    cfg: object
    mode: str            # 'serve' | 'train_step'
    dtype: str           # 'f32' | 'bf16' | 'bf16_scope=...' | 'bf16_compute'
    shape: tuple
    batch: int
    device: object
    context: object


def build_runner(config, batch=1, height=352, width=1216, train_step=False,
                 bf16=False, device="cuda", seed=0, autotuner=True) -> Runner:
    """The model of a preset (a name or an `ExperimentConfig`), cast as its
    precision asks, and the iteration to time."""
    import torch

    from gedepth_tpu_torch.apis.inference import cast_params_bf16
    from gedepth_tpu_torch.configs import get_config

    # f32 means f32: cuDNN would otherwise run f32 convolutions in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(config) if isinstance(config, str) else config
    device = torch.device(device)
    model = cfg.model.build(device=device,
                            generator=torch.Generator().manual_seed(seed))
    img = benchmark_input(cfg.model.pe_variant, batch, height, width, device)
    ch = torch.full((batch,), cfg.model.default_cam_height, device=device)
    scope = cfg.model.bf16_scope
    context = contextlib.nullcontext

    if train_step:
        from gedepth_tpu_torch.train.loop import cudnn_autotuner
        from gedepth_tpu_torch.train.steps import (
            create_train_state, make_train_step)

        dtype = "bf16_compute" if bf16 else "f32"
        state = create_train_state(model, cfg.optim, 1000, seed=seed + 1)
        step = make_train_step(cfg.optim.sig_loss_weight,
                               cfg.optim.slope_ce_weight, bf16=bf16)
        data = {"img": img, "depth_gt": img[..., 0].abs() * 10,
                "pe_k_gt": torch.zeros_like(img[..., 0]), "cam_height": ch}
        if autotuner:
            context = cudnn_autotuner
        else:
            dtype += ", cuDNN heuristic"

        def run():
            return step(state, data)["loss"]
    else:
        if bf16:
            cast_params_bf16(model, "all")
            dtype = "bf16"
        elif scope != "none":
            cast_params_bf16(model, scope)
            dtype = f"bf16_scope={scope}"
        else:
            dtype = "f32"
        x = img.to(torch.bfloat16) if bf16 else img

        @torch.inference_mode()
        def run():
            return model.predict_depth(x, ch)

    return Runner(run, cfg, "train_step" if train_step else "serve", dtype,
                  (height, width), batch, device, context)


def time_iterations(runner: Runner, iters: int):
    """`iters` iterations back to back: (the device's ms of each by CUDA
    events, or None on the CPU; the synchronised host clock's ms for them
    all; the last output)."""
    import torch

    cuda = runner.device.type == "cuda"
    events, out = [], None
    if cuda:
        torch.cuda.synchronize(runner.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = runner.run()
        if cuda:
            end.record()
            events.append((start, end))
    if cuda:
        torch.cuda.synchronize(runner.device)
    host_ms = (time.perf_counter() - t0) * 1e3
    device_ms = [a.elapsed_time(b) for a, b in events] if cuda else None
    return device_ms, host_ms, out


def device_busy_ms(runner: Runner, traces: int = 3):
    """The summed durations of the kernels, copies and fills of one
    iteration, in ms, as `torch.profiler` sees them: the largest of
    `traces` one-iteration traces (an ageing process's profiler drops
    device activities, which can only lower a reading). None on the CPU and
    where no trace saw the device."""
    import torch

    if runner.device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = 0.0
    for _ in range(traces):
        torch.cuda.synchronize(runner.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner.run()
            torch.cuda.synchronize(runner.device)
        best = max(best, sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / 1e3)
    return best or None


def summarise(runner: Runner, iters, device_ms, host_ms, warmup,
              first_step_ms=None, peak_mem_mib=None, busy_ms=None):
    """The JSON record of `iters` timed iterations: `device_ms` of each (or
    None on the CPU), `host_ms` for all of them, `busy_ms` of one
    (`device_busy_ms`)."""
    record = {
        "preset": runner.cfg.name, "mode": runner.mode,
        "shape": list(runner.shape), "batch": runner.batch,
        "dtype": runner.dtype, "iters": iters, "warmup": warmup,
        "device_ms_median": None, "device_ms_min": None,
        "device_ms_max": None, "host_ms_per_iter": host_ms / iters,
        "device_busy_ms": busy_ms, "device_idle_share": None,
        "idle_from": None, "peak_mem_mib": peak_mem_mib,
        "first_step_ms": first_step_ms, "device": str(runner.device),
        "card": None}
    if device_ms is not None:
        record.update(
            device_ms_median=statistics.median(device_ms),
            device_ms_min=min(device_ms), device_ms_max=max(device_ms),
            device_idle_share=max(0.0, 1.0 - (
                busy_ms * iters if busy_ms else sum(device_ms)) / host_ms),
            idle_from="profiler" if busy_ms else "events",
            card=card_name_and_limit())
    return record


def run_benchmark(config, iters=200, warmup=5, batch=1, height=352, width=1216,
                  train_step=False, bf16=False, device="cuda", trace_dir=None,
                  seed=0, autotuner=True):
    """Time `iters` iterations of one preset; returns the record that `main`
    prints as JSON."""
    import torch

    runner = build_runner(config, batch, height, width, train_step, bf16,
                          device, seed, autotuner)
    cuda = runner.device.type == "cuda"
    with runner.context():
        first = None
        if train_step:
            # the first step carries cuDNN's search: outside the window
            _, first, _ = time_iterations(runner, 1)
        time_iterations(runner, warmup)
        if cuda:
            torch.cuda.reset_peak_memory_stats(runner.device)
        profiler = contextlib.nullcontext()
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            profiler = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []))
        with profiler as prof:
            device_ms, host_ms, out = time_iterations(runner, iters)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        peak = (torch.cuda.max_memory_allocated(runner.device) / 2**20
                if cuda else None)
        busy = device_busy_ms(runner)
    if not bool(torch.isfinite(out.float()).all()):
        raise RuntimeError(f"benchmark {runner.cfg.name}: non-finite output")
    return summarise(runner, iters, device_ms, host_ms, warmup, first, peak,
                     busy)


def main(argv=None):
    from gedepth_tpu_torch.configs import list_configs

    parser = argparse.ArgumentParser(description="Time GEDepth (PyTorch)")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--height", type=int, default=352)
    parser.add_argument("--width", type=int, default=1216)
    parser.add_argument("--trace-dir", default=None,
                        help="write a torch.profiler chrome trace of the "
                        "timed loop here")
    parser.add_argument("--train-step", action="store_true",
                        help="time the training step instead")
    parser.add_argument("--bf16", action="store_true",
                        help="serving: the whole model and the input in "
                        "bf16 (cast once); with --train-step: bf16 forward "
                        "and backward on f32 master weights")
    parser.add_argument("--no-autotuner", action="store_true",
                        help="with --train-step: cuDNN's default heuristic "
                        "instead of its autotuner")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    record = run_benchmark(args.config, iters=args.iters, warmup=args.warmup,
                           batch=args.batch, height=args.height,
                           width=args.width, train_step=args.train_step,
                           bf16=args.bf16, device=args.device,
                           trace_dir=args.trace_dir,
                           autotuner=not args.no_autotuner)
    print(json.dumps(record))
    if args.trace_dir:
        print(f"trace written to {args.trace_dir}")
    ms = record["host_ms_per_iter"]
    print(f"Overall fps: {args.batch * 1e3 / ms:.2f} img / s "
          f"({ms:.1f} ms / iter, batch {args.batch})")


if __name__ == "__main__":
    main()
