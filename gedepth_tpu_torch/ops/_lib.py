"""Build and bind the port's CUDA kernels.

Every `gedepth_tpu_torch/csrc/*.cu` is compiled by `nvcc` on first use (one
process per source, side by side) and linked into one shared library with a
plain C interface, loaded through `ctypes`. The
library lands in `gedepth_tpu_torch/_build/` (git-ignored) under a name that
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads as it is. Nothing here runs at import time: the CPU
tests import every module of the port on machines without `nvcc`.

Each C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()` after the launch; `call` raises when it is
not 0.

The kernels reach PyTorch as dispatcher ops of one namespace (`NAMESPACE`,
`define_op`, registered when their modules are imported): each op has the
plain version as its CPU implementation, its kernel as its CUDA
implementation, a fake implementation that gives the output's shape and
dtype without touching data (so `torch.export` traces through it), and its
backward registered with autograd.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: pointers and the stream as void*, sizes as int, strides as
# long long
_MSDA_FWD = [_P] * 7 + [_I] * 11 + [_P]
_MSDA_BWD = [_P] * 11 + [_I] * 11 + [_P]
_SIGNATURES = {
    "window_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _P],
    "window_attention_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _L, _L, _L, _L, _L, _L, _P],
    "msda_fwd": _MSDA_FWD, "msda_fwd_bf16": _MSDA_FWD,
    "msda_bwd": _MSDA_BWD, "msda_bwd_bf16": [_P] * 11 + [_I] * 12 + [_P],
    "msda_plan": [_P] * 6 + [_I] * 10 + [_P],
    "pe_fusion_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
}

NAMESPACE = "gedepth_torch"

_lib = None
_library = None  # the `torch.library.Library` that holds the ops
build_seconds = None  # wall time of the build (or load) done by `load()`


def define_op(name, schema, cpu, cuda, fake, backward=None,
              setup_context=None):
    """Define the dispatcher op `NAMESPACE::name` with `schema` ("(args) ->
    returns"), its CPU and CUDA implementations, its fake implementation
    and, where given, its backward (`torch.library.register_autograd`);
    returns the op, `torch.ops.<NAMESPACE>.<name>.default`.

    The dispatcher calls the implementations as they are
    (`torch.library.Library.impl`). `torch.library.custom_op` would wrap
    each call in more Python (an alias check and a `torch._dynamo.disable`
    frame): a bf16 forward, bound by its host, makes 27 such calls."""
    import torch

    global _library
    if _library is None:
        _library = torch.library.Library(NAMESPACE, "DEF")
    _library.define(name + schema)
    _library.impl(name, cpu, "CPU")
    _library.impl(name, cuda, "CUDA")
    qualname = f"{NAMESPACE}::{name}"
    torch.library.register_fake(qualname, fake, lib=_library)
    if backward is not None:
        torch.library.register_autograd(qualname, backward,
                                        setup_context=setup_context,
                                        lib=_library)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):     # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgedepth_kernels_{h.hexdigest()[:16]}.so"


def load():
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one nvcc per source, all at once, into a private directory; then
        # link and rename: concurrent processes never see a half-written
        # library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objects = [os.path.join(tmp, src.stem + ".o")
                       for src in sorted(CSRC.glob("*.cu"))]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for obj, src in zip(objects, sorted(CSRC.glob("*.cu")))]
            outputs = [p.communicate() for p in procs]
            for p, (_, err) in zip(procs, outputs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({p.returncode}):\n{err}")
            lib_tmp = os.path.join(tmp, "lib.so")
            link = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objects],
                capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            os.replace(lib_tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def call(name: str, *args) -> None:
    """Launch C entry point `name` on torch's current CUDA stream."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def plain_vjp(plain_fn, inputs, needs_grad, grad_out, *static):
    """Gradients of `plain_fn(*inputs, *static)` for the inputs flagged in
    `needs_grad` (None for the others), by autograd through the plain
    version on detached copies: the backward of a kernel whose TPU
    counterpart also differentiated its XLA reference."""
    import torch

    leaves = [t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs_grad)]
    wanted = [t for t, n in zip(leaves, needs_grad) if n]
    if not wanted:
        return [None] * len(inputs)
    with torch.enable_grad():
        out = plain_fn(*leaves, *static)
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if n else None for n in needs_grad]
