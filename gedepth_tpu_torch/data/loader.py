"""Training batches with background prefetch (the port of
`gedepth_tpu.data.loader.TrainLoader`, one process, one prefetch thread).

Every batch is a pure function of (seed, step, slot): the dataset index of
slot `slot` in step `step` comes from a per-epoch permutation seeded by
(seed, epoch), and the augmentation of that sample from an
`np.random.Generator` seeded by (seed, step, slot), as in the JAX package.
Batches are numpy dicts; the train loop moves them to the device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

BATCH_KEYS = ("img", "depth_gt", "pe_k_gt", "cam_height", "index")
PREFETCH = 2   # batches prepared ahead


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
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in BATCH_KEYS if k in samples[0]}

    def __iter__(self):
        """Batches of steps 0, 1, ... prepared PREFETCH ahead on one
        thread; the thread stops when the iterator is closed, and an error
        in it is raised here."""
        q = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker():
            step = 0
            try:
                while not stop.is_set():
                    put(self.make_batch(step))
                    step += 1
            except Exception as err:   # handed to the consumer, raised there
                put(err)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=5)
