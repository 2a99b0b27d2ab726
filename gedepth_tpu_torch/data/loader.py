"""Training and evaluation batches with background prefetch (the port of
`gedepth_tpu.data.loader`, one process, one prefetch thread).

Every batch is a pure function of (seed, step, slot): the dataset index of
slot `slot` in step `step` comes from a per-epoch permutation seeded by
(seed, epoch), and the augmentation of that sample from an
`np.random.Generator` seeded by (seed, step, slot), as in the JAX package.
`EvalLoader` walks a dataset in order at a fixed batch size. Batches are
numpy dicts; the train loop and the evaluator move them to the device.
"""
from __future__ import annotations

import itertools
import queue
import threading

import numpy as np

BATCH_KEYS = ("img", "depth_gt", "pe_k_gt", "cam_height", "index")
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


class TrainLoader:
    """Infinite iteration-based loader of `batch_size` samples per step."""

    def __init__(self, dataset, pipeline, batch_size, seed=0):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.seed = seed
        self._epoch_cache = (-1, None)

    def _epoch_order(self, epoch):
        if self._epoch_cache[0] != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, 0xE90C4]))
            self._epoch_cache = (epoch, rng.permutation(len(self.dataset)))
        return self._epoch_cache[1]

    def make_batch(self, step):
        """The batch of `step`: each sample seen once per epoch."""
        n = len(self.dataset)
        samples = []
        for slot in range(self.batch_size):
            pos = step * self.batch_size + slot
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, slot]))
            index = int(self._epoch_order(pos // n)[pos % n])
            samples.append(self.pipeline(self.dataset[index], rng))
        return _stack(samples, BATCH_KEYS)

    def __iter__(self):
        """Batches of steps 0, 1, ... without end, prepared ahead."""
        return _prefetched(self.make_batch(step)
                           for step in itertools.count())


class EvalLoader:
    """Ordered eval loader with the tail padded to a fixed batch size.

    Yields (batch, valid): `valid` marks the real rows; padding repeats the
    last sample, and the caller drops padded rows by it."""

    def __init__(self, dataset, pipeline, batch_size):
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        rng = np.random.default_rng(0)   # eval transforms are deterministic
        for start in range(0, n, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size, n)))
            valid = np.zeros(self.batch_size, dtype=bool)
            valid[:len(idxs)] = True
            idxs += [idxs[-1]] * (self.batch_size - len(idxs))
            samples = [self.pipeline(self.dataset[i], rng) for i in idxs]
            yield _stack(samples, EVAL_BATCH_KEYS), valid

    def __iter__(self):
        return _prefetched(self._batches())
