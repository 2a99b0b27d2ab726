"""Peak memory and step time of the train step at the presets' batches,
with Swin remat on and off: which configurations fit one card.

    python -m gedepth_tpu_torch.tools.memory_ladder [--iters 3]
        [--warmup 1] [--presets kitti,ddad] [--dtypes f32,bf16_compute]
        [--device cuda]

Each row is one `tools.benchmark --train-step` process (cuDNN's autotuner
on, TF32 off, the seeded initialisation and the benchmark's batch), so no
row inherits another's allocator state. The rows: KITTI
(`gedepth_adaptive_kitti_tpu`, 352x704) at batch 2, 8 and 16 in f32 and 16
in `bf16_compute`; DDAD (`gedepth_adaptive_ddad_tpu`, 384x640) at 8, 16
and 32 in f32 and 32 in `bf16_compute`; each with `model.swin_remat` true
and false. A row that runs out of device memory is recorded as such
(`oom` and the allocator's message), never shrunk. Prints one JSON line a
row (the benchmark's record, or the failure) and then a table.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

LADDER = {
    "kitti": ("gedepth_adaptive_kitti_tpu", (352, 704),
              [(2, False), (8, False), (16, False), (16, True)]),
    "ddad": ("gedepth_adaptive_ddad_tpu", (384, 640),
             [(8, False), (16, False), (32, False), (32, True)]),
}


def rows(presets, dtypes=("f32", "bf16_compute")):
    """(preset, (H, W), batch, bf16, remat) of every row, in order."""
    for key in presets:
        preset, hw, points = LADDER[key]
        for batch, bf16 in points:
            if ("bf16_compute" if bf16 else "f32") not in dtypes:
                continue
            for remat in (True, False):
                yield preset, hw, batch, bf16, remat


def run_row(preset, hw, batch, bf16, remat, iters, warmup, device,
            timeout=1200):
    """One benchmark process: its record, or {'oom': True, 'error': ...}
    when it ran out of memory, or {'error': ...} for any other failure."""
    cmd = [sys.executable, "-m", "gedepth_tpu_torch.tools.benchmark", preset,
           "--train-step", "--batch", str(batch), "--height", str(hw[0]),
           "--width", str(hw[1]), "--iters", str(iters), "--warmup",
           str(warmup), "--device", device,
           "--options", f"model.swin_remat={str(remat).lower()}"]
    if bf16:
        cmd.append("--bf16")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    head = {"preset": preset, "batch": batch, "shape": list(hw),
            "dtype": "bf16_compute" if bf16 else "f32", "swin_remat": remat,
            "process_s": time.perf_counter() - t0}
    if proc.returncode == 0:
        record = json.loads([ln for ln in proc.stdout.splitlines()
                             if ln.startswith("{")][-1])
        return dict(head, **record, oom=False)
    lines = proc.stderr.strip().splitlines()
    oom = [ln for ln in lines if "out of memory" in ln.lower()]
    return dict(head, oom=bool(oom),
                error=(oom or lines or ["exit %d" % proc.returncode])[-1])


def table(records):
    out = ["| preset | shape | batch | dtype | swin_remat | peak MiB | "
           "step ms (events, median) | busy ms | host ms |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    def cell(x, fmt):
        return "-" if x is None else format(x, fmt)

    for r in records:
        if r.get("error"):
            cells = ["out of memory" if r["oom"] else "failed", "-", "-", "-"]
        else:
            cells = [cell(r["peak_mem_mib"], ".0f"),
                     cell(r["device_ms_median"], ".1f"),
                     cell(r["device_busy_ms"], ".1f"),
                     cell(r["host_ms_per_iter"], ".1f")]
        out.append(f"| {r['preset']} | {r['shape'][0]}x{r['shape'][1]} | "
                   f"{r['batch']} | {r['dtype']} | {r['swin_remat']} | "
                   + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--presets", default="kitti,ddad")
    ap.add_argument("--dtypes", default="f32,bf16_compute")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    records = []
    for row in rows(args.presets.split(","), args.dtypes.split(",")):
        records.append(run_row(*row, args.iters, args.warmup, args.device))
        print(json.dumps(records[-1]), flush=True)
    print(table(records), flush=True)
    return records


if __name__ == "__main__":
    main()
