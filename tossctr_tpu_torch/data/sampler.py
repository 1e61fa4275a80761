"""Batch samplers.

Port of ``tossctr_tpu/data/sampler.py``:

* ``ShuffleBatchSampler``: the per-epoch permutation
  ``np.random.default_rng(seed + epoch)`` of the training loop, or the
  index in order (serving), with or without the last partial batch.
* ``BalancedBatchSampler``: ``round(bs * pos_fraction)`` positives and
  the rest negatives a batch, with replacement, from
  ``np.random.default_rng(seed + epoch)``.  The reference never calls
  ``set_epoch``, so its batches repeat across epochs; the training loop
  calls it, and ``reseed_each_epoch=False`` restores the reference's
  behaviour.

Both are pure functions of (seed, epoch): a resumed epoch replays the
same stream.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class BalancedBatchSampler:
    """Yields positions into ``y`` (the training subset's own index
    space): ``len(y) // batch_size`` batches a pass, each drawn with
    replacement, as the training loop configures the JAX sampler."""

    def __init__(self, y: np.ndarray, batch_size: int, pos_fraction: float = 0.5,
                 seed: int = 777, reseed_each_epoch: bool = True):
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.epoch = 0
        self.reseed_each_epoch = bool(reseed_each_epoch)
        self.pos_idx = np.where(y == 1)[0]
        self.neg_idx = np.where(y == 0)[0]
        if len(self.pos_idx) == 0 or len(self.neg_idx) == 0:
            raise ValueError("BalancedBatchSampler requires both classes.")
        self.num_batches = max(1, len(y) // self.batch_size)
        self.n_pos = int(round(self.batch_size * float(pos_fraction)))
        self.n_neg = self.batch_size - self.n_pos

    def set_epoch(self, epoch: int) -> None:
        if self.reseed_each_epoch:
            self.epoch = int(epoch)

    def __iter__(self) -> Iterator[np.ndarray]:
        g = np.random.default_rng(self.seed + self.epoch)
        P, N = len(self.pos_idx), len(self.neg_idx)
        for _ in range(self.num_batches):
            p_sel = self.pos_idx[g.integers(0, P, size=self.n_pos)]
            n_sel = self.neg_idx[g.integers(0, N, size=self.n_neg)]
            batch = np.concatenate([p_sel, n_sel])
            g.shuffle(batch)
            yield batch

    def __len__(self) -> int:
        return self.num_batches


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
