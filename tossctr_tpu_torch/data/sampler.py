"""Batch sampler.

Port of ``tossctr_tpu/data/sampler.py`` ``ShuffleBatchSampler``: the
per-epoch permutation ``np.random.default_rng(seed + epoch)`` of the
training loop, or the index in order (serving), with or without the
last partial batch.  The balanced sampler waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class ShuffleBatchSampler:
    """Walks ``n_or_index`` in batches of ``batch_size``: permuted anew
    each epoch when ``shuffle`` (DataLoader(shuffle=True), reference
    train.py:108), else in order; ``drop_last`` drops the last partial
    batch."""

    def __init__(self, n_or_index, batch_size: int, seed: int = 777, shuffle: bool = False,
                 drop_last: bool = False):
        if np.isscalar(n_or_index):
            self.index = np.arange(int(n_or_index), dtype=np.int64)
        else:
            self.index = np.asarray(n_or_index, dtype=np.int64)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        n = self.index.shape[0]
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = self.index
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = idx[g.permutation(idx.shape[0])]
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]
