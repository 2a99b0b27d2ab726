"""The measurements behind the plans of kernels B and C
(`gedepth_tpu_torch.ops.msda`): the corner bytes from which an unhinted
launch takes the plan the card makes from the sample positions (`msda_plan`,
`PLAN_MIN_CORNER_BYTES_*`), and B's forward under the compat rule with its
window hint against over the card's plan. Needs an NVIDIA GPU; imports no
JAX.

    python tests/msda_plan_rules.py

For each shape (the exact rule at the KITTI serving and train shapes of
`chip_smoke.py` phase 9, in f32 and bf16, and BinsFormer's encoder at
d = 8, f32 and bf16; the first shape once more at the end) it prints one
JSON line: B
(and C at the train shapes) on their wide instances (`msda_wide`: d = 8
otherwise takes the narrow instance, which plans nothing) over the
unplanned rows and over the card's plan whatever the corner bytes, in ms a call by CUDA events over 10
back-to-back calls (the plan included), twice each in the order unplanned,
planned, unplanned, planned, then once more of each after one call of the
plain version (as `chip_smoke.py` runs it first); and the plan's kernels
and the launches' device ms summed by `torch.profiler`. The card's name
and power limit come first.

    python tests/msda_plan_rules.py --compat

measures the choice between the two plans of B's forward under the compat
rule (`compat_positions`, R = 5 and 6, at the KITTI serving self- and
cross-attention, f32 and bf16): the window hint, whose windows the host
plans from the radius, against the card's plan from the positions. One
JSON line a shape, `B_hinted` and `B_planned` as above.

    python tests/msda_plan_rules.py --budget

measures the stage budget of B's bf16 instance (csrc/msda_fwd_bf16.cu)
at `chip_smoke.py` phase 13's shapes (the windowed and compat R = 5
rules with their hints, the exact rule over the card's plan; serving and
train, self- and cross-attention): over the unplanned rows, and with
`STAGE_SHARE_FORWARD_BF16` at 0 (nothing staged, every corner read
through L1), 0.5 and 1 of the room beside its records (the plan's windows
staged in shared memory). One JSON line a shape, as above.

    python tests/msda_plan_rules.py --bins ROOT [ROOT ...]

times B at BinsFormer's encoder shapes (`chip_smoke.py` phase 37: the
exact rule, 3 levels, 8 heads of 8; serving 6,300 queries, train 2 x
4,641), and C at the train shape, in bf16 and f32 with each checkout
ROOT's own kernels (since the narrow instance, csrc/msda_narrow.cu, what
`msda` and `msda_backward` launch there), in the order given, each in a
process of its own: ms a call by CUDA events (10 calls, twice) and device
ms by `torch.profiler` (B summed, C by kernel: `_C_device`), one JSON line
a shape and root.
Two trees compared on one card: give them as parent, change, change,
parent.

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
    ("bf16_train_self", 2, cs.TRAIN_LEVELS, cs.TRAIN_LEVELS, False, True,
     64, torch.bfloat16),
    ("bf16_train_cross", 2, cs.TRAIN_LEVELS, ((176, 352),), True, True, 64,
     torch.bfloat16),
    ("bins_serving", 1, cs.BINS_SERVE_LEVELS, cs.BINS_SERVE_LEVELS, False,
     False, 8, torch.float32),
    ("bins_train", 2, cs.BINS_TRAIN_LEVELS, cs.BINS_TRAIN_LEVELS, False,
     True, 8, torch.float32),
    ("bf16_bins_train", 2, cs.BINS_TRAIN_LEVELS, cs.BINS_TRAIN_LEVELS, False,
     True, 8, torch.bfloat16),
)
# B under the compat rule: hinted against over the card's plan
COMPAT = tuple((f"compat{R}_{name}{'_bf16' if dtype == torch.bfloat16 else ''}",
                R, grids, learned, dtype)
               for R in (5, 6)
               for name, grids, learned in (
                   ("serving_self", cs.SERVE_LEVELS, False),
                   ("serving_cross", ((176, 608),), True))
               for dtype in (torch.float32, torch.bfloat16))


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


def both(row, name, unplanned, planned, plain,
         labels=("unplanned", "planned")):
    """`name`_unplanned and `name`_planned (or the two `labels`): events
    twice, alternating, once more after the plain version, and device
    ms."""
    first, second = (f"{name}_{label}" for label in labels)
    row[first], row[second] = [], []
    for _ in range(2):
        row[first].append(events(unplanned))
        row[second].append(events(planned))
    plain()
    torch.cuda.synchronize()
    row[f"{first}_after_plain"] = events(unplanned)
    row[f"{second}_after_plain"] = events(planned)
    row[f"{first}_device"] = sum(device_ms(unplanned).values())
    row[f"{second}_device"] = sum(device_ms(planned).values())


LAP = """
import time
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
t0 = time.perf_counter()
cs.phase_rule_kernels()
print(f"[lap] phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
"""


BINS = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from gedepth_tpu_torch.ops import msda as m
cs.phase_device()
cs.phase_build()()
for name, B, levels in (("serving", 1, cs.BINS_SERVE_LEVELS),
                        ("train", 2, cs.BINS_TRAIN_LEVELS)):
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    value = randn(B, sum(a * b for a, b in levels), 8, 8)
    pos, w, _ = cs.rule_positions("exact", randn, g, B, levels, levels,
                                  False)
    gout = randn(B, pos.shape[1], 64)
    row = {"root": ROOT, "shape": name, "queries": pos.shape[1]}
    for dtype in (torch.bfloat16, torch.float32):
        v = value.to(dtype)

        def fn():
            return m.msda(v, levels, pos, w)

        key = str(dtype).split(".")[-1]
        row[key] = [round(cs.burst_ms(fn, calls=10, warmup=2), 4)
                    for _ in range(2)]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        row[key + "_device"] = round(sum(
            e.device_time_total for e in prof.key_averages()) / 5e3, 4)
        if B == 2:
            gv = gout.to(dtype)

            def fc():
                return m.msda_backward(v, levels, pos, w, gv)

            row[key + "_C"] = [round(cs.burst_ms(fc, calls=10, warmup=2), 4)
                               for _ in range(2)]
            fc()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fc()
                torch.cuda.synchronize()
            # device ms a call by kernel: which of C's kernels holds it
            row[key + "_C_device"] = {
                e.key.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("<")[0].split("(")[0]:
                    round(e.device_time_total / 5e3, 4)
                for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps(row), flush=True)
"""


def bins(roots):
    for root in roots:
        subprocess.run([sys.executable, "-c",
                        f"ROOT = {root!r}\n" + BINS], cwd=root, check=True)


# B-bf16's stage budget: phase 13's shapes, with each rule's hint
BUDGET = tuple((f"{rule}_{shape}", B, levels, grids, learned, rule)
               for rule in ("windowed", "compat5", "exact")
               for shape, B, levels, grids, learned in (
                   ("serving_self", 1, cs.SERVE_LEVELS,
                    cs.SERVE_LEVELS[1:] if rule == "windowed"
                    else cs.SERVE_LEVELS, False),
                   ("serving_cross", 1, cs.SERVE_LEVELS, ((176, 608),),
                    rule != "windowed"),
                   ("train_self", 2, cs.TRAIN_LEVELS,
                    cs.TRAIN_LEVELS[1:] if rule == "windowed"
                    else cs.TRAIN_LEVELS, False),
                   ("train_cross", 2, cs.TRAIN_LEVELS, ((176, 352),),
                    rule != "windowed"))
               if rule != "compat5" or shape.startswith("serving"))
SHARES = (0.0, 0.5, 1.0)


def stage_shares(smi):
    """B-bf16 over the unplanned rows and at each share of its stage budget
    (the plan included): one JSON line a shape."""
    for name, B, levels, grids, learned, rule in BUDGET:
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        value = randn(B, sum(a * b for a, b in levels), 8, 64).to(
            torch.bfloat16)
        if rule == "windowed":
            pos, w = cs.msda_inputs(randn, B, levels, grids)
            hint = (grids, cs.RADIUS)
        else:
            pos, w, hint = cs.rule_positions(
                "compat" if rule == "compat5" else "exact", randn, g, B,
                levels, grids, learned, radius=cs.PARITY_RADIUS)
        row = {"shape": name, "card": smi, "queries": pos.shape[1]}
        runs = {"unplanned": lambda: m.msda_unplanned(value, levels, pos, w)}
        for share in SHARES:
            runs[f"share_{share}"] = (
                lambda share=share: staged(share, value, levels, pos, w,
                                           hint))
        for _ in range(2):
            for key, fn in runs.items():
                row.setdefault(key, []).append(events(fn))
        for key, fn in runs.items():
            row[f"{key}_device"] = sum(device_ms(fn).values())
        print(json.dumps(row), flush=True)
        del value, pos, w
        torch.cuda.empty_cache()


def staged(share, value, levels, pos, w, hint):
    m.STAGE_SHARE_FORWARD_BF16 = share
    try:
        return m.msda(value, levels, pos, w, *hint)
    finally:
        m.STAGE_SHARE_FORWARD_BF16 = 0.0


def lap(roots):
    for root in roots:
        print(f"[lap] {root}", flush=True)
        subprocess.run([sys.executable, "-c", LAP], cwd=root, check=True)


def compat(smi):
    """B's forward under the compat rule at the serving shapes, hinted
    (the host's plan of the radius) against over the card's plan (no hint),
    the plan included: one JSON line a shape."""
    for name, R, grids, learned, dtype in COMPAT:
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        levels = cs.SERVE_LEVELS
        value = randn(1, sum(a * b for a, b in levels), 8, 64).to(dtype)
        pos, w, hint = cs.rule_positions("compat", randn, g, 1, levels,
                                         grids, learned, radius=R)
        row = {"shape": name, "card": smi}
        both(row, "B", lambda: m.msda(value, levels, pos, w, *hint),
             lambda: m.msda(value, levels, pos, w),
             lambda: m.msda_plain(value, levels, pos, w),
             labels=("hinted", "planned"))
        print(json.dumps(row), flush=True)
        del value, pos, w
        torch.cuda.empty_cache()


def main():
    if sys.argv[1:2] == ["--lap"]:
        return lap(sys.argv[2:])
    if sys.argv[1:2] == ["--bins"]:
        return bins(sys.argv[2:])
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    # whatever the corner bytes: the rule measured here
    m.PLAN_MIN_CORNER_BYTES_FORWARD = m.PLAN_MIN_CORNER_BYTES_BACKWARD = 0
    if sys.argv[1:2] == ["--compat"]:
        return compat(smi)
    if sys.argv[1:2] == ["--budget"]:
        return stage_shares(smi)
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
        budget = m._forward_geometry(value, value)[2]
        plan = device_ms(lambda: m.msda_plan(pos, levels, d, budget, item))
        row = {"shape": name, "card": smi,
               "plan_device": {k.split("::")[-1].split("(")[0]: v
                               for k, v in plan.items()}}
        # the wide instances, planned (d = 8 launches the narrow one,
        # which takes no plan)
        both(row, "B", lambda: m.msda_unplanned(value, levels, pos, w),
             lambda: m.msda_wide(value, levels, pos, w),
             lambda: m.msda_plain(value, levels, pos, w))
        if backward:
            gout = randn(B, pos.shape[1], 8 * d).to(dtype)
            args = (value, levels, pos, w, gout)
            both(row, "C", lambda: m.msda_backward_unplanned(*args),
                 lambda: m.msda_backward_wide(*args),
                 lambda: m.msda_backward_plain(*args))
            del gout, args
        print(json.dumps(row), flush=True)
        del value, pos, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
