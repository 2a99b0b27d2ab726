#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), CUDA version and
     capability; TF32 off for matmuls and convolutions;
  2. build: the CUDA kernels of gedepth_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version at the
     full-width shapes of the serving slice, with the stated tolerance, and
     the median CUDA-event time of both (which holds the wrapper's host
     time too); kernel A also at the train crop's stage 1 (batch 2), with k
     and v as views into a packed qkv as the model passes them, and with
     the device time per call of both versions beside the event times;
  4. main path: `init_depther("gedepth_adaptive_kitti_tpu")` with a seeded
     random initialisation, then `inference_depther` on 3 synthetic
     375x1242 KITTI-shaped requests (KB crop, normalisation, flip-TTA);
     every depth map (352, 1216), finite and inside [min_depth, max_depth],
     and every kernel's launch count above 0 for this phase;
  5. whole forward: `GEDepth` on one request with the kernels and with the
     plain versions, depth held to rtol 1e-3, atol 1e-3 m;
  6. kernel C: the deformable-sampling backward against its plain twin at
     the train crop's full width (352x704, batch 2), self-attention (5,082
     queries per sample) and cross-attention (61,952): d_pos and d_weights
     rtol 2e-4, atol 2e-5; d_value, summed by atomics in any order, rtol
     2e-4 plus atol 1e-5·max|d_value|; CUDA-event medians of both;
  7. train main path: `train("gedepth_adaptive_kitti_tpu")` for 5 steps at
     352x704, batch 2, on synthetic KITTI-shaped frames from the seeded
     initialisation; every metric finite, every parameter's gradient present
     and finite after the run, a few named ones non-zero, and kernels A, B,
     C and E launched by it;
  8. whole step: one train step with the kernels and one with the plain
     versions on the same weights, batch and generator seed (full Swin-L,
     crop 176x352, batch 2): loss rtol 1e-4, each parameter's gradient
     ‖g − g_plain‖ <= 1e-3·‖g_plain‖ + 1e-7. The absolute term covers the
     gradients that are zero but for rounding: a LayerNorm bias that feeds
     only a conv and a train-mode BatchNorm (backbone.norm{i}.bias) shifts
     each channel by a constant the BatchNorm takes out again, so both
     sides hold noise of ~1e-8 there. The decode head's conv weights are
     the most sensitive: a relative change of 1e-7 in the window
     attention's output moves them by ~4.5e-4 relative, ~0.45 of the
     bound. Kernel A therefore rounds as its plain version does.
Then the kernels as one JSON line (launches from phase 7), and last the
device as one JSON line.
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


def device_ms(fn, reps=10, warmup=2):
    """Median over `reps` calls of fn() of the device time per call in
    milliseconds: the summed durations of the kernels, copies and fills
    that `torch.profiler` saw on the card during the call. Each call runs
    in its own named range that ends in a synchronise; a device activity
    belongs to the last range that started before it. Returns (median,
    activities per call), or (None, 0) when the profiler saw none."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"chip_smoke_call_{i}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name.startswith("chip_smoke_call_")
                    and e.device_type == DeviceType.CPU)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("chip_smoke_call_")]
    if len(starts) != reps or not device:
        return None, 0
    per_call = [0.0] * reps
    for e in device:
        i = max(bisect.bisect_right(starts, e.time_range.start) - 1, 0)
        per_call[i] += e.time_range.elapsed_us()
    return statistics.median(per_call) / 1e3, len(device) / reps


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
    # unmasked and masked, stage 3 (22x76 -> 28x77: 44 windows, 24 heads),
    # and the train crop's stage 1 at batch 2 (88x176 -> 91x182: 2 x 338
    # windows, mask period 338); k and v are views into a packed qkv
    print("[kernels] A window attention (rtol 2e-4, atol 2e-5)")
    for label, nWB, H, grid in (("stage1", 572, 6, None),
                                ("stage1_shifted", 572, 6, (91, 308)),
                                ("stage3_shifted", 44, 24, (28, 77)),
                                ("train_stage1_shifted", 676, 6, (91, 182))):
        qkv = randn(nWB, 49, 3, H, 32)
        q, k, v = qkv[:, :, 0] * 32 ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        bias = randn(H, 49, 49)
        mask = None if grid is None else torch.as_tensor(
            shifted_window_mask(*grid, 7, 3), device="cuda")
        shape = f"({nWB},49,{H},32)" + (
            "" if mask is None else f" mask {tuple(mask.shape)}")
        err = compare(f"A {label} {shape}",
                      wa.window_attention(q, k, v, bias, mask),
                      wa.window_attention_plain(q, k, v, bias, mask),
                      2e-4, 2e-5)

        def kernel():
            return wa.window_attention(q, k, v, bias, mask)

        def plain():
            return wa.window_attention_plain(q, k, v, bias, mask)

        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        (dev, n_dev), (plain_dev, n_plain) = device_ms(kernel), \
            device_ms(plain)
        dev, plain_dev = ("not measured" if x is None else f"{x:.4f}"
                          for x in (dev, plain_dev))
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} (CUDA events) "
              f"device_ms={dev} plain_device_ms={plain_dev} "
              f"(profiler; {n_dev:g} and {n_plain:g} device activities a "
              f"call)", flush=True)
        if label == "stage1_shifted":   # the JSON line keeps this shape
            results["window_attention"] = (err, ms, plain_ms)
        del qkv, q, k, v

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


TRAIN_LEVELS = ((88, 176), (44, 88), (22, 44), (11, 22))


def phase_kernel_c():
    from gedepth_tpu_torch.ops import msda as msda_ops

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    print("[kernel C] deformable-sampling backward, value (2,20570,8,64) "
          "(d_pos, d_w: rtol 2e-4, atol 2e-5; d_value: rtol 2e-4, "
          "atol 1e-5*max|d_value|)")
    value = randn(2, sum(a * b for a, b in TRAIN_LEVELS), 8, 64)
    result = None
    for label, grids in (("self_attn", TRAIN_LEVELS[1:]),
                         ("cross_attn", ((176, 352),))):
        Nq = sum(a * b for a, b in grids)
        pos = msda_ops.windowed_positions(2.0 * randn(2, Nq, 8, 4, 8, 2),
                                          grids, TRAIN_LEVELS, 4)
        w = randn(2, Nq, 8, 32).softmax(-1).view(2, Nq, 8, 4, 8)
        gout = randn(2, Nq, 512)
        args = (value, TRAIN_LEVELS, pos, w, gout)
        got = msda_ops.msda_backward(*args)
        want = msda_ops.msda_backward_plain(*args)
        dv_atol = 1e-5 * want[0].abs().max().item()
        err = max(compare(f"C {label} Nq={Nq} d_value", got[0], want[0],
                          2e-4, dv_atol),
                  compare(f"C {label} Nq={Nq} d_pos", got[1], want[1],
                          2e-4, 2e-5),
                  compare(f"C {label} Nq={Nq} d_weights", got[2], want[2],
                          2e-4, 2e-5))
        del got, want
        ms = cuda_ms(lambda: msda_ops.msda_backward(*args))
        plain_ms = cuda_ms(lambda: msda_ops.msda_backward_plain(*args),
                           reps=3, warmup=1)
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        result = (err, ms, plain_ms)    # cross_attn is kept
        del pos, w, gout, args
    torch.cuda.empty_cache()
    return result


def _kernel_counters():
    from gedepth_tpu_torch.ops import msda as msda_ops
    from gedepth_tpu_torch.ops import pe_fusion as pe_ops
    from gedepth_tpu_torch.ops import window_attention as wa

    return {"window_attention": wa.window_attention, "msda": msda_ops.msda,
            "msda_backward": msda_ops.msda_backward,
            "pe_fusion": pe_ops.pe_fusion}


def phase_train():
    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.train.loop import train

    import dataclasses

    # the reference's per-GPU batch of 2 (its global batch spans 8 GPUs)
    cfg = get_config(PRESET)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, global_batch=2))
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=5, device="cuda")
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}

    print(f"[train] train({PRESET!r}, max_iters=5), global_batch 2, crop "
          f"{cfg.data.crop_size}, synthetic frames {cfg.data.eval_size}: "
          f"{wall:.2f} s including init")
    for r in history:
        print(f"[train] iter {r['iter']} loss={r['loss']:.6f} "
              f"loss_depth={r['loss_depth']:.6f} "
              f"loss_slope={r['loss_slope']:.6f} "
              f"grad_norm={r['grad_norm']:.6f} lr={r['lr']:.6e} "
              f"step_ms={r['time'] * 1e3:.3f} "
              f"step_peak_mem_mib={r['peak_mem_mib']:.1f}", flush=True)
    print(f"[train] peak device memory: step 1 (cuDNN's autotuner trying "
          f"algorithms) {history[0]['peak_mem_mib']:.1f} MiB, later steps "
          f"{max(r['peak_mem_mib'] for r in history[1:]):.1f} MiB; "
          f"launches {launches}", flush=True)
    for r in history:
        if not all(np.isfinite(v) for v in r.values()):
            fail(f"non-finite train metrics at iter {r['iter']}: {r}")
    missing, bad = [], []
    for name, p in state.model.named_parameters():
        if p.grad is None:
            missing.append(name)
        elif not bool(torch.isfinite(p.grad).all()):
            bad.append(name)
    if missing or bad:
        fail(f"parameters without a gradient {missing[:8]} "
             f"({len(missing)}), with a non-finite one {bad[:8]}")
    grads = dict(state.model.named_parameters())
    for name in ("backbone.stages.0.blocks.0.attn.w_msa.qkv.weight",
                 "neck.self_attn.sampling_offsets.weight",
                 "neck.multi_att.value_proj.weight",
                 "dynamic_pe_neck.conv0.weight"):
        norm = grads[name].grad.norm().item()
        print(f"[train] |grad {name}| = {norm:.6e}")
        if not norm > 0:
            fail(f"zero gradient for {name}")
    print(f"[train] all {len(grads)} parameters have finite gradients after "
          "the last step", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the train path")
    del state
    torch.cuda.empty_cache()
    return launches


def phase_whole_step():
    import dataclasses

    from gedepth_tpu_torch.configs import get_config
    from gedepth_tpu_torch.data.loader import TrainLoader
    from gedepth_tpu_torch.data.synthetic import SyntheticGroundDataset
    from gedepth_tpu_torch.data.transforms import build_train_pipeline
    from gedepth_tpu_torch.train.steps import (
        batch_to_device, create_train_state, make_train_step)

    cfg = get_config(PRESET)
    data = dataclasses.replace(cfg.data, crop_size=(176, 352))
    loader = TrainLoader(SyntheticGroundDataset(size=4, height=176,
                                                width=352),
                         build_train_pipeline(data), 2, seed=SEED)
    batch = batch_to_device(loader.make_batch(0), "cuda")
    step = make_train_step(cfg.optim.sig_loss_weight,
                           cfg.optim.slope_ce_weight)
    results = []
    for use_kernels in (True, False):
        model = cfg.model.build(
            device="cuda", generator=torch.Generator().manual_seed(SEED))
        state = create_train_state(model, cfg.optim, cfg.train.max_iters,
                                   seed=SEED + 1)
        with (contextlib.nullcontext() if use_kernels else plain_ops()):
            metrics = step(state, batch)
        torch.cuda.synchronize()
        results.append((metrics["loss"].item(),
                        {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}))
        del model, state
        torch.cuda.empty_cache()
    (loss_k, grads_k), (loss_p, grads_p) = results
    print(f"[step] one train step, kernels vs plain, crop 176x352 batch 2: "
          f"loss {loss_k:.8f} vs {loss_p:.8f}")
    if not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        fail("train-step loss disagrees with the plain versions")
    worst, worst_rel = (0.0, ""), (0.0, "")
    for name, gp in grads_p.items():
        diff, norm = (grads_k[name] - gp).norm().item(), gp.norm().item()
        bound = 1e-3 * norm + 1e-7
        if not diff <= bound:
            fail(f"gradient of {name} disagrees: |g - g_plain| {diff:.3e} > "
                 f"{bound:.3e}")
        worst = max(worst, (diff / bound, name))
        if norm > 1e-4:
            worst_rel = max(worst_rel, (diff / norm, name))
    print(f"[step] all {len(grads_p)} gradients within their bound; the "
          f"closest: {worst[1]} at {worst[0]:.3f} of it; the largest "
          f"relative error where |g_plain| > 1e-4: {worst_rel[0]:.3e} "
          f"({worst_rel[1]})", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    handle, requests, _ = phase_main_path()
    phase_whole_forward(handle, requests)
    del handle
    torch.cuda.empty_cache()
    results["msda_backward"] = phase_kernel_c()
    launches = phase_train()
    phase_whole_step()

    sources = {
        "window_attention": ("gedepth_tpu_torch/csrc/window_attention.cu",
                             "gedepth_tpu/ops/pallas/window_attn.py:49"),
        "msda": ("gedepth_tpu_torch/csrc/msda.cu",
                 "gedepth_tpu/ops/pallas/msda_windowed.py:112"),
        "msda_backward": ("gedepth_tpu_torch/csrc/msda_bwd.cu",
                          "gedepth_tpu/ops/pallas/msda_windowed.py:898"),
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
