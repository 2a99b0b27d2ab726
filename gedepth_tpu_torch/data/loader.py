"""Training and evaluation batches (the port of `gedepth_tpu.data.loader`).

Every batch is a pure function of (seed, step, slot): the dataset index of
slot `slot` in step `step` comes from a per-epoch permutation seeded by
(seed, epoch) ('epoch' sampling) or from i.i.d. draws seeded by (seed, step)
('replacement'), and the augmentation of that sample from an
`np.random.Generator` seeded by (seed, step, slot), as in the JAX package.
So a process of a multi-process run makes only its rows of the global
batch, and the stream is the same for any number of loader workers.
`EvalLoader` walks a dataset, or one process's strided shard of it, in
order at a fixed batch size. `TrainLoader.make_batch` and `EvalLoader` give
numpy dicts; the train stream gives dicts of CPU tensors (pinned for a CUDA
run when workers make them); the train loop and the evaluator move them to
the device.
"""
from __future__ import annotations

import itertools
import multiprocessing
import queue
import threading

import numpy as np
import torch

BATCH_KEYS = ("img", "depth_gt", "pe_k_gt", "cam_height", "index",
              "scene_class")
EVAL_BATCH_KEYS = ("img", "cam_height", "index")
PREFETCH = 2   # batches prepared ahead


def _stack(samples, keys):
    return {k: np.stack([np.asarray(s[k]) for s in samples])
            for k in keys if k in samples[0]}


def _prefetched(items):
    """Iterate `items` (an iterator), prepared PREFETCH ahead on one
    thread; the thread stops when the iterator is closed or exhausted, and
    an error in it is raised here."""
    q = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    done = object()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for item in items:
                if stop.is_set():
                    return
                put(item)
            put(done)
        except Exception as err:   # handed to the consumer, raised there
            put(err)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=5)


SAMPLINGS = ("epoch", "replacement")
FORKSERVER_PRELOAD = ("__main__", "torch", "gedepth_tpu_torch.data")


def _as_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _StepBatches(torch.utils.data.Dataset):
    """The map-style dataset of a worker: item `step` is this process's
    rows of batch `step`, as tensors (they leave the worker through shared
    memory, not a pickle)."""

    def __init__(self, loader):
        self.loader = loader

    def __getitem__(self, step):
        return _as_tensors(self.loader.make_batch(step))


class _Steps(torch.utils.data.Sampler):
    """0, 1, 2, ... without end."""

    def __iter__(self):
        return itertools.count()


class TrainLoader:
    """Infinite iteration-based loader of `global_batch` samples a step, of
    which this process makes rows [shard_index·local, (shard_index+1)·local)
    with local = global_batch / shard_count.

    sampling: 'epoch' (every sample once an epoch, from a permutation of
    (seed, epoch): the reference's DistributedSampler) or 'replacement'
    (i.i.d. uniform indices of (seed, step)), the JAX package's two rules.

    num_workers: 0 prepares the batches on one prefetch thread; n > 0 on n
    worker processes of a `torch.utils.data.DataLoader` (one torch thread
    each, PREFETCH batches each in flight, order kept), which yield the
    same batches. The workers fork from a forkserver: a clean process, not
    the trainer's threads, whose children leave by `os._exit` (a spawned
    worker's interpreter exit aborted now and then in torch's static
    destructors) and which has imported FORKSERVER_PRELOAD once for all of
    them. They need the dataset and the pipeline to pickle and touch no
    CUDA; `pin_memory` pins their batches for a CUDA run. A worker that
    dies raises in the consumer."""

    def __init__(self, dataset, pipeline, global_batch, seed=0,
                 shard_index=0, shard_count=1, num_workers=0,
                 sampling="epoch", pin_memory=False):
        if global_batch % shard_count:
            raise ValueError(f"global batch {global_batch} does not divide "
                             f"into {shard_count} shards")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        if sampling not in SAMPLINGS:
            raise ValueError(f"sampling {sampling!r} not in {SAMPLINGS}")
        self.dataset = dataset
        self.pipeline = pipeline
        self.global_batch = global_batch
        self.local_batch = global_batch // shard_count
        self.seed = seed
        self.shard_index, self.shard_count = shard_index, shard_count
        self.num_workers = num_workers
        self.sampling = sampling
        self.pin_memory = pin_memory
        self._epoch_cache = (-1, None)

    def _epoch_order(self, epoch):
        if self._epoch_cache[0] != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, 0xE90C4]))
            self._epoch_cache = (epoch, rng.permutation(len(self.dataset)))
        return self._epoch_cache[1]

    def _index_for(self, step, slot):
        """Dataset index of global slot `slot` of batch `step`."""
        if self.sampling == "replacement":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 0xA11CE]))
            return int(rng.integers(0, len(self.dataset),
                                    size=self.global_batch)[slot])
        pos = step * self.global_batch + slot
        n = len(self.dataset)
        return int(self._epoch_order(pos // n)[pos % n])

    def make_batch(self, step):
        """This process's rows of the batch of `step`, numpy."""
        lo = self.shard_index * self.local_batch
        samples = []
        for slot in range(lo, lo + self.local_batch):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, slot]))
            samples.append(self.pipeline(
                self.dataset[self._index_for(step, slot)], rng))
        return _stack(samples, BATCH_KEYS)

    def __iter__(self):
        """Batches of steps 0, 1, ... without end, prepared ahead; the
        workers (if any) start here, before the first batch is asked for."""
        if self.num_workers == 0:
            return _prefetched(_as_tensors(self.make_batch(step))
                               for step in itertools.count())
        from gedepth_tpu_torch.utils import jpeg, png

        png.load_library()  # built here once, not by each worker at once
        jpeg.load_library()
        context = multiprocessing.get_context("forkserver")
        # what every worker imports, imported once by the server it forks
        # from (when this call starts the server)
        context.set_forkserver_preload(list(FORKSERVER_PRELOAD))
        return _drain(iter(torch.utils.data.DataLoader(
            _StepBatches(self), batch_size=None, sampler=_Steps(),
            num_workers=self.num_workers, prefetch_factor=PREFETCH,
            collate_fn=_identity, pin_memory=self.pin_memory,
            multiprocessing_context=context)))


def _drain(batches):
    """Yield from a DataLoader iterator; its workers stop with it."""
    try:
        yield from batches
    except (EOFError, ConnectionError) as err:
        # a worker died while it handed over a batch's shared memory
        raise RuntimeError("a loader worker died") from err
    finally:
        del batches     # its finaliser stops the workers


def _identity(batch):
    return batch


def stop_worker_server():
    """Stop the processes that closed `TrainLoader`s leave behind in this
    process: the forkserver their workers forked from and multiprocessing's
    resource tracker. Either stops by itself only after this process has
    exited, the forkserver once its interpreter, which has imported torch,
    has shut down. A program that must stop every process it starts calls
    this when no loader is open; a later loader starts both again."""
    import gc
    import os
    import signal
    from multiprocessing import forkserver, resource_tracker

    gc.collect()    # the closed loaders' queues release their semaphores
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        # the server holds no state: killed, it skips torch's finalisers
        os.kill(server._forkserver_pid, signal.SIGKILL)
        server._stop()
    resource_tracker._resource_tracker._stop()


class EvalLoader:
    """Ordered eval loader with the tail padded to a fixed batch size.

    Yields (batch, valid): `valid` marks the real rows; padding repeats the
    last sample, and the caller drops padded rows by it. shard_index /
    shard_count: one process of a multi-process evaluation walks
    range(shard_index, len(dataset), shard_count), the reference's
    DistributedSampler split; the caller gathers the per-image metrics."""

    def __init__(self, dataset, pipeline, batch_size, shard_index=0,
                 shard_count=1):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.indices = range(shard_index, len(dataset), shard_count)

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def _batches(self):
        rng = np.random.default_rng(0)   # eval transforms are deterministic
        for start in range(0, len(self.indices), self.batch_size):
            idxs = list(self.indices[start:start + self.batch_size])
            valid = np.zeros(self.batch_size, dtype=bool)
            valid[:len(idxs)] = True
            idxs += [idxs[-1]] * (self.batch_size - len(idxs))
            samples = [self.pipeline(self.dataset[i], rng) for i in idxs]
            yield _stack(samples, EVAL_BATCH_KEYS), valid

    def __iter__(self):
        return _prefetched(self._batches())
