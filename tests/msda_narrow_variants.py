"""Variants of the narrow instance of kernels B and C
(`gedepth_tpu_torch/csrc/msda_narrow.cu`) against the kept form, on the
card: each a copy of the source with one change, built by nvcc into a
library of its own and timed at BinsFormer's encoder shapes (`chip_smoke.py`
phase 37: the exact rule, 3 levels, 8 heads of 8, 8 points; serving 6,300
queries, train 2 x 4,641), in f32 and bf16, device ms a call by
`torch.profiler`. Needs an NVIDIA GPU and nvcc; imports no JAX.

    python tests/msda_narrow_variants.py

Prints the card's name and power limit, then one JSON line a shape and
dtype: B_<variant> (serving and train) and C_<variant> (train) in ms, and
ok_<variant>: B equal to the kept form bit for bit, C's d_pos and d_w
likewise and d_value within 1e-2 of it (`no_adds` and `scatter` are
diagnostics that compute something else: not held). The variants:

  kept                   the source as it is
  one_lane_adds          C: each lane adds its whole corner (two 16-byte
                         reductions of one lane into one 32-byte sector)
  presum_warp            C: corners that land on the same (pixel, head)
                         within a warp (`__match_any_sync` on the address)
                         summed through shared memory before one add
  presum_warp_one_head   the same with a warp of 32 queries of one head
                         (neighbouring queries, which share pixels most)
  bulk                   C: a corner's adds as one TMA bulk reduction of 32
                         bytes from shared memory (`cp.reduce.async.bulk`)
  no_adds, scatter       C without its d_value adds; with them sent to
                         addresses that share no neighbours (diagnostics)
  b_one_thread           B f32: one thread a query and head reads both
                         16-byte slices
  b_shared_setup         B f32: each lane of a slice pair sets up half the
                         samples and the pair swaps them by shuffles
  block_128 ... _1024    every kernel in blocks of that many threads
"""
import ctypes
import json
import os.path as osp
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, osp.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import msda_plan_rules as rules  # noqa: E402
from gedepth_tpu_torch.ops import _lib  # noqa: E402
from gedepth_tpu_torch.ops import msda as m  # noqa: E402

ADDS = """        for (int i = 0; i < 4; ++i)  // cw 0: outside the level
          adds.add(dvl + at.off[i], active ? a[j] * cw[i] : 0.f);"""
ACTIVE = """  const bool active = t < n_qh;
  const long long qh = active ? t : n_qh - 1;"""
G_ROW = """  float g[D];
  load_head(g, grad_out + qh * D);"""
BWD_END = """          reinterpret_cast<float2*>(d_pos + row * 2)[k0 + j] =
              make_float2(dx[j], dy[j]);
        }
      }
    }
  }
}"""
BWD_GRID = "grid_of(n_qh, kNarrowThreads), kNarrowThreads"

PRESUM = """        for (int i = 0; i < 4; ++i) {
          const int lane = threadIdx.x % 32;
          float* sb = presum[threadIdx.x / 32];
          const float wc = active ? a[j] * cw[i] : 0.f;
          float* p = dvl + at.off[i];
          const unsigned long long key =
              wc != 0.f ? reinterpret_cast<unsigned long long>(p)
                        : ~0ull - lane;
          const unsigned peers = __match_any_sync(kFullMask, key);
          if (__any_sync(kFullMask, __popc(peers) > 1)) {
            for (int c = 0; c < D; ++c) sb[lane * D + c] = wc * g[c];
            __syncwarp();
            if (wc != 0.f && lane == __ffs(peers) - 1) {
              float sum[D];
              for (int c = 0; c < D; ++c) sum[c] = 0.f;
              for (unsigned mm = peers; mm; mm &= mm - 1)
                for (int c = 0; c < D; ++c)
                  sum[c] += sb[(__ffs(mm) - 1) * D + c];
              for (int k = 0; k < D / 4; ++k)
                atomicAdd(reinterpret_cast<float4*>(p + 4 * k),
                          make_float4(sum[4 * k], sum[4 * k + 1],
                                      sum[4 * k + 2], sum[4 * k + 3]));
            }
            __syncwarp();
          } else if (wc != 0.f) {
            for (int k = 0; k < D / 4; ++k)
              atomicAdd(reinterpret_cast<float4*>(p + 4 * k),
                        make_float4(wc * g[4 * k], wc * g[4 * k + 1],
                                    wc * g[4 * k + 2], wc * g[4 * k + 3]));
          }
        }"""
PRESUM_SHARED = G_ROW.replace(
    "  float g[D];\n",
    "  float g[D];\n  __shared__ float presum[kNarrowThreads / 32][32 * D];\n")
ONE_HEAD = """  const long long nb = n_qh / h, warp = t / 32;
  const long long qf = (warp / h) * 32 + (t % 32);
  const bool active = qf < nb;
  const long long qh = (active ? qf : nb - 1) * h + warp % h;"""
ONE_HEAD_GRID = ("grid_of((n_qh / h + 31) / 32 * h * 32, kNarrowThreads), "
                 "kNarrowThreads")
BULK = """        if constexpr (D > 8) {
""" + ADDS + """
        } else {
          float (*sl)[8] = slots[(k0 + j + l * P) & 1][threadIdx.x];
          // the reductions issued two samples ago have read their slots
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
          float wcs[4];
          for (int i = 0; i < 4; ++i) {
            wcs[i] = active ? a[j] * cw[i] : 0.f;
            if (wcs[i] != 0.f)
              for (int c = 0; c < D; ++c) sl[i][c] = wcs[i] * g[c];
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          for (int i = 0; i < 4; ++i) {
            if (wcs[i] == 0.f) continue;
            const unsigned at_s = static_cast<unsigned>(
                __cvta_generic_to_shared(&sl[i][0]));
            asm volatile(
                "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
                " [%0], [%1], %2;" :: "l"(dvl + at.off[i]), "r"(at_s),
                "r"(D * 4) : "memory");
          }
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }"""
BULK_SHARED = G_ROW.replace(
    "  float g[D];\n",
    "  float g[D];\n"
    "  __shared__ __align__(128) float slots[2][kNarrowThreads][4][8];\n")
BULK_END = BWD_END[:-1] + (
    '  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");\n}')
B_QH = """  const long long qh = t / kSlices;
  if (qh >= n_qh) return;"""
B_QH_ALL = """  const bool active = t / kSlices < n_qh;
  const long long qh = active ? t / kSlices : n_qh - 1;"""
B_SAMPLES = """#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!kVec && k0 + j >= P) break;
        const Record r =
            setup_sample(x[j], y[j], a[j], Hl, Wl, kUnstaged, D, hd).rec;
        blend<E>(acc, vl, r);
      }"""
B_SHARED = """      if constexpr (kSlices == 2) {
        // lane s of a pair sets up samples j + s, and the pair swaps them
        const int s = (int)(t & 1);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (!kVec && k0 + j >= P) break;
          const Record r = setup_sample(s ? x[j + 1] : x[j],
                                        s ? y[j + 1] : y[j],
                                        s ? a[j + 1] : a[j], Hl, Wl,
                                        kUnstaged, D, hd).rec;
          Record o;
          o.c00 = __shfl_xor_sync(kFullMask, r.c00, 1);
          o.c01 = __shfl_xor_sync(kFullMask, r.c01, 1);
          o.c10 = __shfl_xor_sync(kFullMask, r.c10, 1);
          o.c11 = __shfl_xor_sync(kFullMask, r.c11, 1);
          o.a = __shfl_xor_sync(kFullMask, r.a, 1);
          o.off = __shfl_xor_sync(kFullMask, r.off, 1);
          o.sx = __shfl_xor_sync(kFullMask, r.sx, 1);
          o.sy = __shfl_xor_sync(kFullMask, r.sy, 1);
          blend<E>(acc, vl, s ? o : r);
          if (!kVec && k0 + j + 1 >= P) break;
          blend<E>(acc, vl, s ? r : o);
        }
      } else {
""" + B_SAMPLES + """
      }"""
B_STORE = "  store_head<E>(out + qh * D + c0, acc);"
SCATTER = """        for (int i = 0; i < 4; ++i) {
          const long long n_el = (n_qh / ((long long)Nq * h)) * S * hd;
          const long long k = ((t * 96 + (l * P + k0 + j) * 4 + i) *
                               2654435761LL) % (n_el / 8 - 1);
          adds.add(d_value + k * 8, active ? a[j] * cw[i] : 0.f);
        }"""


def block(n):
    """Every kernel in blocks of n threads."""
    return [("constexpr int kNarrowThreads = 128;",
             f"constexpr int kNarrowThreads = {n};"),
            ("return sizeof(T) == 4 ? 256 : 128;", f"return {n};")]


VARIANTS = {
    "kept": [],
    "one_lane_adds": [("bool kPairs = D % 8 == 0>", "bool kPairs = false>")],
    "presum_warp": [(ADDS, PRESUM), (G_ROW, PRESUM_SHARED)],
    "presum_warp_one_head": [(ADDS, PRESUM), (G_ROW, PRESUM_SHARED),
                             (ACTIVE, ONE_HEAD), (BWD_GRID, ONE_HEAD_GRID)],
    "bulk": [(ADDS, BULK), (G_ROW, BULK_SHARED), (BWD_END, BULK_END)],
    "no_adds": [(ADDS, "")],
    "scatter": [(ADDS, SCATTER)],
    "b_one_thread": [("constexpr int E = slice_elems<T>(), kSlices = D / E;",
                      "constexpr int E = D, kSlices = 1;"),
                     ("grid_of(n_qh * (D / slice_elems<T>()), block)",
                      "grid_of(n_qh, block)")],
    "b_shared_setup": [(B_QH, B_QH_ALL), (B_SAMPLES, B_SHARED),
                       (B_STORE, "  if (active) " + B_STORE.lstrip())],
    **{f"block_{n}": block(n) for n in (128, 256, 512, 1024)},
}
DIAGNOSTIC = ("no_adds", "scatter")


def build(work):
    """One library a variant, nvcc's processes side by side."""
    src = osp.join(_lib.CSRC, "msda_narrow.cu")
    text = open(src).read()
    procs = {}
    for name, patches in VARIANTS.items():
        patched = text
        for old, new in patches:
            if old not in patched:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old[:60]!r}")
            patched = patched.replace(old, new)
        cu = osp.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(patched)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared",
             "-o",
             osp.join(work, f"{name}.so"), cu],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed\n{p.stderr.read()}")
        lib = ctypes.CDLL(osp.join(work, f"{name}.so"))
        for fn in ("msda_narrow_fwd", "msda_narrow_fwd_bf16",
                   "msda_narrow_bwd", "msda_narrow_bwd_bf16"):
            getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def measure(libs, smi):
    def stream():
        return torch.cuda.current_stream().cuda_stream

    for label, B, levels in (("serving", 1, cs.BINS_SERVE_LEVELS),
                             ("train", 2, cs.BINS_TRAIN_LEVELS)):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        value = randn(B, sum(a * b for a, b in levels), 8, 8)
        pos, w, _ = cs.rule_positions("exact", randn, g, B, levels, levels,
                                      False)
        gout = randn(B, pos.shape[1], 64)
        table = m._level_table(levels, value.device)
        S, Nq = value.shape[1], pos.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            v, go = value.to(dtype), gout.to(dtype)
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            out = v.new_empty(B, Nq, 64)
            d_value = torch.empty_like(v)
            acc = (d_value if dtype == torch.float32
                   else torch.empty_like(v, dtype=torch.float32))
            d_pos, d_w = torch.empty_like(pos), torch.empty_like(w)
            want = m.msda(v, levels, pos, w)
            want_b = m.msda_backward(v, levels, pos, w, go)
            row = {"shape": label, "dtype": str(dtype).split(".")[-1],
                   "card": smi}
            # the first calls timed in a process read low: a warm-up
            for name, lib in [("", libs["kept"])] + list(libs.items()):
                fwd = getattr(lib, "msda_narrow_fwd" + suffix)
                bwd = getattr(lib, "msda_narrow_bwd" + suffix)

                def b_call():
                    if fwd(v.data_ptr(), table.data_ptr(), pos.data_ptr(),
                           w.data_ptr(), out.data_ptr(), B, S, Nq, 8, 8, 3,
                           8, 1, stream()):
                        raise SystemExit(f"{name}: B failed to launch")

                def c_call():
                    if bwd(v.data_ptr(), table.data_ptr(), pos.data_ptr(),
                           w.data_ptr(), go.data_ptr(), acc.data_ptr(),
                           d_value.data_ptr(), d_pos.data_ptr(),
                           d_w.data_ptr(), B, S, Nq, 8, 8, 3, 8, 1,
                           stream()):
                        raise SystemExit(f"{name}: C failed to launch")

                if not name:
                    rules.device_ms(b_call)
                    if B == 2:
                        rules.device_ms(c_call)
                    continue
                b_call()
                torch.cuda.synchronize()
                ok = torch.equal(out, want)
                row[f"B_{name}"] = round(sum(
                    t for k, t in rules.device_ms(b_call).items()
                    if "narrow" in k), 4)
                if B == 2:
                    c_call()
                    torch.cuda.synchronize()
                    ok = ok and torch.equal(d_pos, want_b[1]) \
                        and torch.equal(d_w, want_b[2]) and (
                            d_value.float() - want_b[0].float()).abs().max(
                            ).item() < 1e-2
                    row[f"C_{name}"] = round(sum(
                        t for k, t in rules.device_ms(c_call).items()
                        if "narrow" in k), 4)
                if name not in DIAGNOSTIC:
                    row[f"ok_{name}"] = ok
            print(json.dumps(row), flush=True)


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    _lib.load()
    work = tempfile.mkdtemp(prefix="msda_narrow_variants_")
    try:
        measure(build(work), smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
