"""Data parallelism over processes (the counterpart of the data-parallel
half of `gedepth_tpu.parallel.mesh`, on `torch.distributed`).

The JAX package trains one GSPMD program over every device: the loss, its
BatchNorm statistics and its random masks are those of the global batch,
whatever the number of devices. The port keeps that contract with one
process per card. Every process runs the same step on its rows of the
global batch; the quantities that span the batch (SigLoss's mean and
variance, the slope cross entropy's mean, every BatchNorm's statistics) are
formed from sums reduced over the processes by `global_sum`, an all-reduce
whose backward all-reduces the incoming gradient. The global loss is then
the same number on every process, each process's parameter gradient is the
world size times its rows' share of the global gradient, and
`average_gradients` (an all-reduce divided by the world size) leaves every
process with the gradient of the global loss. A world of one changes
nothing: without a process group every function here is the identity.

Set-up follows `torchrun`'s environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL for CUDA devices, gloo on
the CPU.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# gradients all-reduced per call, in elements (128 MiB of f32)
BUCKET_ELEMENTS = 1 << 25
# how long a collective waits for the other processes
TIMEOUT = datetime.timedelta(minutes=30)


def active() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def backend():
    """The process group's backend ('nccl', 'gloo'), None without one."""
    return dist.get_backend() if active() else None


def barrier():
    if active():
        dist.barrier()


def init_from_env(device: str = "cuda",
                  backend: str | None = None) -> torch.device:
    """Join the process group that `torchrun` describes in the environment
    and return this process's device: `cuda:LOCAL_RANK` (made current) for
    device 'cuda', else the CPU. backend: NCCL for CUDA and gloo for the
    CPU unless given (gloo also takes CUDA tensors, and NCCL refuses two
    ranks on one card)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no torchrun environment: {missing} unset "
                           "(launch with python -m torch.distributed.run)")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dev


def shutdown():
    if active():
        dist.destroy_process_group()


def local_rows(global_batch: int) -> int:
    """This process's rows of a global batch; raises unless the world size
    divides it (the JAX loader asserts the same)."""
    w = world()
    if global_batch % w:
        raise ValueError(f"global batch {global_batch} does not divide by "
                         f"the world size {w}")
    return global_batch // w


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) forward and backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the processes, differentiable; the identity
    without a process group."""
    if not active():
        return x
    return _GlobalSum.apply(x)


@torch.no_grad()
def average_gradients(params):
    """Replace every `.grad` of `params` by its mean over the processes, in
    buckets of at most BUCKET_ELEMENTS; nothing without a process group."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    w = world()
    bucket, size = [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat /= w
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    for g in grads:
        if bucket and size + g.numel() > BUCKET_ELEMENTS:
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()


def broadcast_object(obj, src: int = 0):
    """`obj` of process `src` on every process (pickled; only this
    program's own objects go through it)."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def comm_device(fallback: torch.device) -> torch.device:
    """Where tensors for a collective must live: the current CUDA device
    under NCCL, else `fallback` (gloo takes CPU and CUDA tensors)."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return fallback
