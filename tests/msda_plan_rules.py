"""The measurements behind the corner rule of the plan that kernels B and C
make on the card from the sample positions (`gedepth_tpu_torch.ops.msda`
`msda_plan`): the corner bytes from which an unhinted launch plans
(`PLAN_MIN_CORNER_BYTES_*`). Needs an NVIDIA GPU; imports no JAX.

    python tests/msda_plan_rules.py

For each shape (the exact rule at the KITTI serving and train shapes of
`chip_smoke.py` phase 9, in f32 and bf16, and BinsFormer's encoder at
d = 8; the first shape once more at the end) it prints one JSON line: B
(and C at the train shapes) over the unplanned rows and over the card's
plan whatever the corner bytes, in ms a call by CUDA events over 10
back-to-back calls (the plan included), twice each in the order unplanned,
planned, unplanned, planned, then once more of each after one call of the
plain version (as `chip_smoke.py` runs it first); and the plan's kernels
and the launches' device ms summed by `torch.profiler`. The card's name
and power limit come first.

    python tests/msda_plan_rules.py --lap ROOT [ROOT ...]

runs `chip_smoke.py` phase 9 (`phase_rule_kernels`) of each checkout
ROOT, in the order given, each in a process of its own after the script's
device and build phases, and prints its lines and its lap in seconds by
the host clock: two trees compared on one card.
"""
import json
import os.path as osp
import subprocess
import sys

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gedepth_tpu_torch.ops import msda as m  # noqa: E402

SHAPES = (
    # name, batch, levels, query grids, learned anchors, backward, head
    # width, value dtype
    ("serving_self", 1, cs.SERVE_LEVELS, cs.SERVE_LEVELS, False, False, 64,
     torch.float32),
    ("serving_cross", 1, cs.SERVE_LEVELS, ((176, 608),), True, False, 64,
     torch.float32),
    ("train_self", 2, cs.TRAIN_LEVELS, cs.TRAIN_LEVELS, False, True, 64,
     torch.float32),
    ("train_cross", 2, cs.TRAIN_LEVELS, ((176, 352),), True, True, 64,
     torch.float32),
    ("bf16_serving_self", 1, cs.SERVE_LEVELS, cs.SERVE_LEVELS, False,
     False, 64, torch.bfloat16),
    ("bf16_serving_cross", 1, cs.SERVE_LEVELS, ((176, 608),), True, False,
     64, torch.bfloat16),
    ("bf16_train_cross", 2, cs.TRAIN_LEVELS, ((176, 352),), True, True, 64,
     torch.bfloat16),
    ("bins_serving", 1, cs.BINS_SERVE_LEVELS, cs.BINS_SERVE_LEVELS, False,
     False, 8, torch.float32),
    ("bins_train", 2, cs.BINS_TRAIN_LEVELS, cs.BINS_TRAIN_LEVELS, False,
     True, 8, torch.float32),
)


def device_ms(fn, reps=5):
    """Device ms a call of each kernel (and copy or fill) that
    `torch.profiler` saw, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: round(e.device_time_total / reps / 1e3, 4)
            for e in prof.key_averages() if e.device_time_total > 0}


def events(fn):
    return round(cs.burst_ms(fn, calls=10, warmup=2), 4)


def both(row, name, unplanned, planned, plain):
    """`name`_unplanned and `name`_planned: events twice, alternating, once
    more after the plain version, and device ms."""
    row[f"{name}_unplanned"], row[f"{name}_planned"] = [], []
    for _ in range(2):
        row[f"{name}_unplanned"].append(events(unplanned))
        row[f"{name}_planned"].append(events(planned))
    plain()
    torch.cuda.synchronize()
    row[f"{name}_unplanned_after_plain"] = events(unplanned)
    row[f"{name}_planned_after_plain"] = events(planned)
    row[f"{name}_unplanned_device"] = sum(device_ms(unplanned).values())
    row[f"{name}_planned_device"] = sum(device_ms(planned).values())


LAP = """
import time
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
t0 = time.perf_counter()
cs.phase_rule_kernels()
print(f"[lap] phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
"""


def lap(roots):
    for root in roots:
        print(f"[lap] {root}", flush=True)
        subprocess.run([sys.executable, "-c", LAP], cwd=root, check=True)


def main():
    if sys.argv[1:2] == ["--lap"]:
        return lap(sys.argv[2:])
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    # whatever the corner bytes: the rule measured here
    m.PLAN_MIN_CORNER_BYTES_FORWARD = m.PLAN_MIN_CORNER_BYTES_BACKWARD = 0
    for name, B, levels, grids, learned, backward, d, dtype \
            in SHAPES + SHAPES[:1]:
        # a generator seeded as phase 9's, afresh for each shape
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        value = randn(B, sum(a * b for a, b in levels), 8, d).to(dtype)
        pos, w, _ = cs.rule_positions("exact", randn, g, B, levels, grids,
                                      learned)
        item = value.element_size()
        budget = m.stage_budget(d, m.channel_lanes(d, itemsize=item)[1])
        plan = device_ms(lambda: m.msda_plan(pos, levels, d, budget, item))
        row = {"shape": name, "card": smi,
               "plan_device": {k.split("::")[-1].split("(")[0]: v
                               for k, v in plan.items()}}
        both(row, "B", lambda: m.msda_unplanned(value, levels, pos, w),
             lambda: m.msda(value, levels, pos, w),
             lambda: m.msda_plain(value, levels, pos, w))
        if backward:
            gout = randn(B, pos.shape[1], 8 * d).to(dtype)
            args = (value, levels, pos, w, gout)
            both(row, "C", lambda: m.msda_backward_unplanned(*args),
                 lambda: m.msda_backward(*args),
                 lambda: m.msda_backward_plain(*args))
            del gout, args
        print(json.dumps(row), flush=True)
        del value, pos, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
