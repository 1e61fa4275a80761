"""Host-side batch iteration and the device prefetcher.

Port of ``tossctr_tpu/data/loader.py``.  ``BatchIterator``: batches keep
a static size: the last partial batch is padded by repeating its last
index and carries a ``valid`` mask (unless the sampler drops it).  The
padding must be exactly the JAX package's, because ``SEBlock`` takes its
statistics over the whole batch, so every output depends on which rows
share its batch.  Unlike the JAX class, ``train`` defaults to False,
the serving path's mode.  ``DevicePrefetcher``: a background thread
assembles the next host batches and copies them to the device, so the
gathers overlap the steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .dataset import ShardCache
from .sampler import BalancedBatchSampler, ShuffleBatchSampler

# the keys a model batch carries to the device (ids stay on the host)
DEVICE_KEYS = ("X_num", "X_mask", "X_cat", "seq", "y", "valid")
PREFETCH_DEPTH = 2  # host batches in flight


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
                 sampler=None, drop_last: Optional[bool] = None):
        self.cache = cache
        self.index = np.arange(len(cache), dtype=np.int64) if index is None else np.asarray(index)
        self.batch_size = int(batch_size)
        self.train = bool(train)
        self.sampler = sampler if sampler is not None else ShuffleBatchSampler(
            self.index, batch_size, seed=seed, shuffle=shuffle,
            drop_last=train if drop_last is None else drop_last,
        )

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches()

    def batches(self, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches after the first ``skip``, which the sampler
        draws but nothing gathers (the resume of a fold mid-epoch)."""
        for b, idx in enumerate(self.sampler):
            if b < skip:
                continue
            # the balanced sampler yields positions in the index
            gidx = self.index[idx] if isinstance(self.sampler, BalancedBatchSampler) else idx
            n = gidx.shape[0]
            pad = self.batch_size - n
            if pad > 0:
                gidx = np.concatenate([gidx, np.repeat(gidx[-1:], pad)])
            batch = self.cache.gather(gidx, train=self.train)
            batch["valid"] = (np.arange(self.batch_size) < n).astype(np.float32)
            yield batch


class DevicePrefetcher:
    """Iterates ``it``'s host batches as dicts of tensors on ``device``:
    a background thread gathers up to PREFETCH_DEPTH batches ahead and copies
    each from pinned memory with ``non_blocking`` (on a CUDA device), so
    the step never waits on the host's gather.  ``ids`` stay numpy.  An
    error in the thread is raised in the consumer."""

    _END = object()

    def __init__(self, it, device):
        self._it = it
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, batch) -> Dict:
        pin = self._device.type == "cuda"
        out = {}
        for k, v in batch.items():
            if k in DEVICE_KEYS:
                t = torch.from_numpy(v)
                out[k] = t.pin_memory().to(self._device, non_blocking=True) if pin \
                    else t.to(self._device)
            else:
                out[k] = v
        return out

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._put(batch))
        except BaseException as e:  # surfaces in the consumer
            self._err = e
        finally:
            self._q.put(self._END)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._END:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:  # a consumer that stops early lets the thread end
            self._stop.set()
            while self._thread.is_alive():
                try:
                    self._q.get(timeout=0.1)
                except queue.Empty:
                    pass
