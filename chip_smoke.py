#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), CUDA version and
     capability; TF32 off for matmuls and convolutions;
  2. build: the CUDA kernels of gedepth_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the
     full-width shapes of the serving slice, with the stated tolerance, and
     the median CUDA-event time of both;
  4. main path: `init_depther("gedepth_adaptive_kitti_tpu")` with a seeded
     random initialisation, then `inference_depther` on 3 synthetic
     375x1242 KITTI-shaped requests (KB crop, normalisation, flip-TTA);
     every depth map (352, 1216), finite and inside [min_depth, max_depth],
     and every kernel's launch count above 0 for this phase;
  5. whole forward: `GEDepth` on one request with the kernels and with the
     plain versions, depth held to rtol 1e-3, atol 1e-3 m.
Then the kernels as one JSON line, and last the device as one JSON line.
Imports nothing of JAX. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
PRESET = "gedepth_adaptive_kitti_tpu"


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, rtol, atol):
    """Max abs/rel error of got vs want; fails past atol + rtol·|want|."""
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-6)).max().item()
    excess = (diff - (atol + rtol * want.abs())).max().item()
    ok = bool(torch.isfinite(got).all()) and excess <= 0
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap} name {torch.cuda.get_device_name(0)}",
          flush=True)
    if cap != (9, 0):
        fail(f"the kernels are built for sm_90a, card has {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from gedepth_tpu_torch.ops import _lib
    _lib.load()
    print(f"[build] {_lib.library_path().name} in "
          f"{_lib.build_seconds:.2f} s", flush=True)


def phase_kernels():
    from gedepth_tpu_torch.models.swin import shifted_window_mask
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    results = {}
    # A: Swin-L stage 1 (88x304 padded to 91x308: 572 windows, 6 heads)
    # unmasked and masked, and stage 3 (22x76 -> 28x77: 44 windows, 24 heads)
    print("[kernels] A window attention (rtol 2e-4, atol 2e-5)")
    for label, nWB, H, grid in (("stage1", 572, 6, None),
                                ("stage1_shifted", 572, 6, (91, 308)),
                                ("stage3_shifted", 44, 24, (28, 77))):
        q, k, v = (randn(nWB, 49, H, 32) for _ in range(3))
        q = q * 32 ** -0.5
        bias = randn(H, 49, 49)
        mask = None if grid is None else torch.as_tensor(
            shifted_window_mask(*grid, 7, 3), device="cuda")
        err = compare(f"A {label} ({nWB},49,{H},32)",
                      wa.window_attention(q, k, v, bias, mask),
                      wa.window_attention_plain(q, k, v, bias, mask),
                      2e-4, 2e-5)
        ms = cuda_ms(lambda: wa.window_attention(q, k, v, bias, mask))
        plain_ms = cuda_ms(
            lambda: wa.window_attention_plain(q, k, v, bias, mask))
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        if label == "stage1_shifted":   # the JSON line keeps this shape
            results["window_attention"] = (err, ms, plain_ms)

    # B: HAHI, value 35,530 tokens x 8 heads x 64 over 4 levels
    print("[kernels] B deformable sampling (rtol 2e-4, atol 2e-5)")
    levels = ((88, 304), (44, 152), (22, 76), (11, 38))
    value = randn(1, sum(a * b for a, b in levels), 8, 64)
    for label, grids in (("self_attn", levels[1:]),
                         ("cross_attn", ((176, 608),))):
        Nq = sum(a * b for a, b in grids)
        pos = msda_ops.windowed_positions(2.0 * randn(1, Nq, 8, 4, 8, 2),
                                          grids, levels, 4)
        w = randn(1, Nq, 8, 32).softmax(-1).view(1, Nq, 8, 4, 8)
        err = compare(f"B {label} Nq={Nq}",
                      msda_ops.msda(value, levels, pos, w),
                      msda_ops.msda_plain(value, levels, pos, w), 2e-4, 2e-5)
        ms = cuda_ms(lambda: msda_ops.msda(value, levels, pos, w))
        plain_ms = cuda_ms(
            lambda: msda_ops.msda_plain(value, levels, pos, w), reps=3)
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        results["msda"] = (err, ms, plain_ms)   # cross_attn is kept
        del pos, w

    # E: PE fusion over the full 352x1216 crop
    print("[kernels] E PE fusion (rtol 1e-4, atol 1e-4)")
    logits = randn(1, 352, 1216, 11)
    pe = torch.rand(1, 352, 1216, generator=g, device="cuda") * 78 + 2
    y = torch.rand(1, 352, 1216, generator=g, device="cuda")
    cam = torch.full((1,), 1.65, device="cuda")
    err = compare("E (1,352,1216,11)",
                  pe_ops.pe_fusion(logits, pe, y, cam, 200.0),
                  pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0),
                  1e-4, 1e-4)
    ms = cuda_ms(lambda: pe_ops.pe_fusion(logits, pe, y, cam, 200.0))
    plain_ms = cuda_ms(
        lambda: pe_ops.pe_fusion_plain(logits, pe, y, cam, 200.0))
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    results["pe_fusion"] = (err, ms, plain_ms)
    return results


def phase_main_path():
    import dataclasses

    from gedepth_tpu_torch.apis import (
        inference_depther, init_depther, make_eval_step)
    from gedepth_tpu_torch.data.synthetic import synthetic_request
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    rng = np.random.default_rng(SEED)
    requests = [synthetic_request(rng) for _ in range(3)]
    t0 = time.perf_counter()
    handle = init_depther(PRESET, device="cuda", pe_raw=requests[0][1],
                          seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in handle.model.parameters())
    print(f"[main] init_depther({PRESET!r}): {n_params} parameters in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg = handle.cfg.model

    counters = (wa.window_attention, msda_ops.msda, pe_ops.pe_fusion)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    latencies, depths = [], []
    for rgb, _ in requests:
        t = time.perf_counter()
        depths.append(inference_depther(handle, rgb))
        latencies.append((time.perf_counter() - t) * 1e3)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    print(f"[main] flip-TTA request latency ms: "
          f"{[round(x, 3) for x in latencies]}")
    print(f"[main] peak device memory {peak / 2**20:.1f} MiB; launches "
          f"{launches}", flush=True)
    for i, d in enumerate(depths):
        if d.shape != (352, 1216):
            fail(f"request {i}: depth shape {d.shape}")
        if not np.isfinite(d).all():
            fail(f"request {i}: non-finite depth")
        if d.min() < cfg.min_depth - 1e-6 or d.max() > cfg.max_depth + 1e-4:
            fail(f"request {i}: depth outside [{cfg.min_depth}, "
                 f"{cfg.max_depth}]: {d.min()}..{d.max()}")
    print(f"[main] depth (352, 1216) finite in [{min(d.min() for d in depths):.4f}"
          f", {max(d.max() for d in depths):.4f}] m", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    no_flip = dataclasses.replace(
        handle, eval_step=make_eval_step(handle.model, flip_tta=False))
    lat_nf = []
    for rgb, _ in requests:
        t = time.perf_counter()
        inference_depther(no_flip, rgb)
        lat_nf.append((time.perf_counter() - t) * 1e3)
    print(f"[main] no-flip request latency ms: "
          f"{[round(x, 3) for x in lat_nf]}", flush=True)
    return handle, requests, launches


@contextlib.contextmanager
def plain_ops():
    """Route the model's three ops to their plain PyTorch versions."""
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    with mock.patch.object(wa, "window_attention",
                           wa.window_attention_plain), \
            mock.patch.object(msda_ops, "msda", msda_ops.msda_plain), \
            mock.patch.object(pe_ops, "pe_fusion", pe_ops.pe_fusion_plain):
        yield


def phase_whole_forward(handle, requests):
    from gedepth_tpu_torch.geometry.plane import clip_pe_for_input

    rgb, pe = requests[0]
    img = np.concatenate([rgb, clip_pe_for_input(pe)[..., None],
                          pe[..., None]], axis=-1)
    img = handle.pipeline({"img": img})["img"]
    x = torch.from_numpy(np.ascontiguousarray(img[None])).cuda()
    cam = torch.full((1,), 1.65, device="cuda")
    with torch.inference_mode():
        got = handle.model(x, cam)["depth"]
        with plain_ops():
            want = handle.model(x, cam)["depth"]
    print("[whole] GEDepth depth, kernels vs plain (f32, TF32 off)")
    compare("depth (1,176,608,1)", got, want, 1e-3, 1e-3)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    handle, requests, launches = phase_main_path()
    phase_whole_forward(handle, requests)

    sources = {
        "window_attention": ("gedepth_tpu_torch/csrc/window_attention.cu",
                             "gedepth_tpu/ops/pallas/window_attn.py:49"),
        "msda": ("gedepth_tpu_torch/csrc/msda.cu",
                 "gedepth_tpu/ops/pallas/msda_windowed.py:112"),
        "pe_fusion": ("gedepth_tpu_torch/csrc/pe_fusion.cu",
                      "gedepth_tpu/ops/pallas/pe_fusion.py:57"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        err, ms, plain_ms = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"[power] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
