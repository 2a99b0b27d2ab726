"""Dataset wrappers (the port of `gedepth_tpu.data.wrappers`)."""
from __future__ import annotations

import bisect


class ConcatDataset:
    """Concatenation of datasets sharing a sample contract; a sample's
    `index` is its position in the concatenation."""

    def __init__(self, datasets):
        assert datasets
        self.datasets = list(datasets)
        self.cum = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cum.append(total)

    def __len__(self):
        return self.cum[-1]

    def _locate(self, idx):
        ds_idx = bisect.bisect_right(self.cum, idx)
        prev = self.cum[ds_idx - 1] if ds_idx else 0
        return ds_idx, idx - prev

    def __getitem__(self, idx):
        ds_idx, local = self._locate(idx)
        sample = self.datasets[ds_idx][local]
        sample["index"] = idx
        return sample

    def load_gt(self, idx):
        ds_idx, local = self._locate(idx)
        return self.datasets[ds_idx].load_gt(local)


class RepeatDataset:
    """A dataset repeated `times` times (a longer epoch)."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def load_gt(self, idx):
        return self.dataset.load_gt(idx % len(self.dataset))
