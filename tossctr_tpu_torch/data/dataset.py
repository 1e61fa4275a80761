"""Shard-cache reading: batch-granular gathers over mmap'd NPY shards.

Port of ``tossctr_tpu/data/dataset.py``: the same ``manifest.json``
format (written by ``tossctr_tpu/data/etl.py`` or by this package's
``data/synth.py``), the same ``dims``, the same ``gather`` (features
with labels for training, with ids for serving) and the labels and CV
groups of the whole cache for the fold split.  A batch's rows are copied
by the native threaded gather (``native/``, built at first use; the same
bytes as NumPy's), as the JAX package does when its library builds;
``TOSSCTR_NATIVE_GATHER=0`` takes NumPy's fancy indexing instead.  A
failed build raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..native import gather_rows_multi

_KEYS = ["X_num", "X_mask", "X_cat", "seq", "y", "groups", "ids"]


def use_native_gather() -> bool:
    """The native threaded gather unless TOSSCTR_NATIVE_GATHER=0."""
    return os.environ.get("TOSSCTR_NATIVE_GATHER", "1") != "0"


class _Shard:
    def __init__(self, meta: dict):
        self.meta = meta
        self.rows = int(meta["rows"])
        self.start = int(meta["start"])
        self.end = int(meta["end"])
        self._arrs: Optional[Dict[str, np.ndarray]] = None

    @property
    def arrs(self) -> Dict[str, np.ndarray]:
        if self._arrs is None:
            a = {}
            for k in _KEYS:
                if k in self.meta and isinstance(self.meta[k], dict):
                    # ids are small; load eagerly
                    mmap = None if k == "ids" else "r"
                    a[k] = np.load(self.meta[k]["path"], mmap_mode=mmap)
            self._arrs = a
        return self._arrs


class ShardCache:
    """Global-index view over a shard-cache manifest; ``gather(idx)``
    returns the batch dict for arbitrary global indices, order kept."""

    def __init__(self, manifest_path: str):
        with open(manifest_path, "r") as f:
            self.manifest = json.load(f)
        self.shards = [_Shard(m) for m in self.manifest["shards"]]
        self.ends = np.array([s.end for s in self.shards], dtype=np.int64)
        self.starts = np.array([s.start for s in self.shards], dtype=np.int64)
        self.rows = int(self.manifest["rows"])
        self.num_cols: List[str] = self.manifest.get("num_cols", [])
        self.cat_cols: List[str] = self.manifest.get("cat_cols", [])

    def __len__(self) -> int:
        return self.rows

    @property
    def dims(self) -> Dict[str, int]:
        """Feature dims from shard-0 metadata."""
        m0 = self.manifest["shards"][0]
        return {
            "X_num": int(m0["X_num"]["shape"][1]),
            "X_mask": int(m0["X_mask"]["shape"][1]),
            "X_cat": int(m0["X_cat"]["shape"][1]),
            "seq_len": int(m0["seq"]["shape"][1]),
        }

    def gather(self, idx: np.ndarray, train: bool = True) -> Dict[str, np.ndarray]:
        """Features of rows ``idx``, with the labels ``y`` (fp32) when
        ``train``, else with the ids."""
        idx = np.asarray(idx, dtype=np.int64)
        sid = np.searchsorted(self.ends, idx, side="right")
        n = idx.shape[0]
        d = self.dims
        batch: Dict[str, np.ndarray] = {
            "X_num": np.empty((n, d["X_num"]), np.float32),
            "X_mask": np.empty((n, d["X_mask"]), np.float32),
            "X_cat": np.empty((n, d["X_cat"]), np.int32),
            "seq": np.empty((n, d["seq_len"]), np.int32),
        }
        if train:
            batch["y"] = np.empty((n,), np.float32)
        else:
            batch["ids"] = np.empty((n,), dtype="U64")
        keys = ["X_num", "X_mask", "X_cat", "seq"] + (["y"] if train else [])
        for s in np.unique(sid):
            sel = sid == s
            li = idx[sel] - self.starts[s]
            arrs = self.shards[s].arrs
            # sorted local indices for sequential mmap access, then unsort
            order = np.argsort(li, kind="stable")
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            li_sorted = li[order]
            raw = _gather_raw(arrs, keys, li_sorted)
            batch["X_num"][sel] = raw["X_num"].astype(np.float32, copy=False)[inv]
            batch["X_mask"][sel] = raw["X_mask"].astype(np.float32)[inv]
            batch["X_cat"][sel] = raw["X_cat"][inv]
            batch["seq"][sel] = raw["seq"][inv]
            if train:
                batch["y"][sel] = raw["y"].astype(np.float32)[inv]
            elif "ids" in arrs:
                batch["ids"][sel] = arrs["ids"][li_sorted][inv]
        return batch

    def labels(self) -> np.ndarray:
        """Every row's label, in cache order."""
        return np.concatenate([np.asarray(s.arrs["y"]) for s in self.shards])

    def groups(self) -> np.ndarray:
        """Every row's CV group id, in cache order."""
        return np.concatenate([np.asarray(s.arrs["groups"]) for s in self.shards])


def _gather_raw(arrs, keys, li_sorted) -> Dict[str, np.ndarray]:
    """The rows ``li_sorted`` of each array ``keys`` of one shard."""
    if use_native_gather():
        return dict(zip(keys, gather_rows_multi([arrs[k] for k in keys], li_sorted)))
    return {k: arrs[k][li_sorted] for k in keys}


def load_labels_groups_for_split(manifest_path: str):
    """(y, groups) concatenated across shards for the CV split."""
    cache = ShardCache(manifest_path)
    return cache.labels(), cache.groups()
