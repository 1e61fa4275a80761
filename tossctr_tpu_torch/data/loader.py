"""Host-side batch iteration.

Port of ``tossctr_tpu/data/loader.py`` ``BatchIterator``.  Batches keep
a static size: the last partial batch is padded by repeating its last
index and carries a ``valid`` mask (unless the sampler drops it).  The
padding must be exactly the JAX package's, because ``SEBlock`` takes its
statistics over the whole batch, so every output depends on which rows
share its batch.  Unlike the JAX class, ``train`` defaults to False,
the serving path's mode.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .dataset import ShardCache
from .sampler import ShuffleBatchSampler


class BatchIterator:
    """Yields host batches (dicts of numpy arrays with ``valid``) of
    exactly ``batch_size`` rows over ``index`` (default: the whole cache).

    train=True  -> batches carry ``y``; ``shuffle`` permutes the index
                   each epoch (``set_epoch``); the last partial batch is
                   kept unless ``drop_last`` (default: train).
    train=False -> batches carry ``ids``; the cache in order, every row.
    """

    def __init__(self, cache: ShardCache, index: Optional[np.ndarray] = None, *,
                 batch_size: int, train: bool = False, shuffle: bool = False, seed: int = 777,
                 drop_last: Optional[bool] = None):
        self.cache = cache
        self.index = np.arange(len(cache), dtype=np.int64) if index is None else np.asarray(index)
        self.batch_size = int(batch_size)
        self.train = bool(train)
        self.sampler = ShuffleBatchSampler(
            self.index, batch_size, seed=seed, shuffle=shuffle,
            drop_last=train if drop_last is None else drop_last,
        )

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for gidx in self.sampler:
            n = gidx.shape[0]
            pad = self.batch_size - n
            if pad > 0:
                gidx = np.concatenate([gidx, np.repeat(gidx[-1:], pad)])
            batch = self.cache.gather(gidx, train=self.train)
            batch["valid"] = (np.arange(self.batch_size) < n).astype(np.float32)
            yield batch
