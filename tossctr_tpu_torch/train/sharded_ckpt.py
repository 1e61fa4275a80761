"""Reading the JAX package's row-sharded pytree checkpoints.

The load side of ``tossctr_tpu/train/sharded_ckpt.py``.  A pod-trained
fold's ``params/`` or ``ema/`` is such a directory:

    <dir>/
      index.json          {key: {kind: sharded|dense|none, shape, dtype,
                           rows: [[r0, r1], ...]}}, keys "/"-joined paths
      dense.msgpack       every replicated or small leaf, one flax msgpack
      <key>.r<r0>.npy     rows [r0, r1) of a row-sharded leaf, "/" as "__"

A dtype NumPy cannot save (bfloat16) is stored as the same-width
unsigned-int view and viewed back bit for bit.  The leaves come back as
torch tensors on the host, the row-sharded ones assembled whole: one
device serves them.  Writing this form needs row sharding (ROADMAP
queue 1 item 8).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from . import flax_msgpack

SEP = "/"
# the dtypes NumPy cannot hold, stored as their bits (torch dtype, bits' NumPy dtype)
_VIEWED = {"bfloat16": (torch.bfloat16, np.int16)}


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, "index.json"))


def _fname(key: str, r0: int) -> str:
    return key.replace(SEP, "__") + f".r{r0}.npy"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _load_sharded(dir_path: str, key: str, entry: Dict) -> torch.Tensor:
    """A row-sharded leaf, every row file read once into one host tensor."""
    shape = tuple(entry["shape"])
    name = entry["dtype"]
    if name in _VIEWED:
        dtype, bits = _VIEWED[name]
        out = torch.empty(shape, dtype=dtype)
        dst = out.view(torch.int16)
    else:
        bits = np.dtype(name)
        out = dst = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, bits)).dtype)
    covered = 0
    for r0, r1 in sorted(entry["rows"]):
        if r0 != covered:
            raise ValueError(f"{dir_path}: {key} rows [{covered}, {r0}) missing")
        arr = np.load(os.path.join(dir_path, _fname(key, r0)), mmap_mode="r")
        if arr.shape != (r1 - r0,) + shape[1:] or arr.dtype.itemsize != np.dtype(bits).itemsize:
            raise ValueError(f"{dir_path}: {_fname(key, r0)} holds {arr.dtype}{arr.shape}, "
                             f"not rows [{r0}, {r1}) of {name}{shape}")
        dst[r0:r1] = torch.from_numpy(np.array(arr).view(bits))
        covered = r1
    if covered != shape[0]:
        raise ValueError(f"{dir_path}: {key} rows [{covered}, {shape[0]}) missing")
    return out


def load_sharded_pytree(dir_path: str) -> Any:
    """The tree ``save_sharded_pytree`` wrote into ``dir_path``: nested
    dicts with torch tensor leaves (None where the tree held None)."""
    with open(os.path.join(dir_path, "index.json")) as f:
        index = json.load(f)
    dense = _flatten(flax_msgpack.load(os.path.join(dir_path, "dense.msgpack")))
    flat: Dict[str, Any] = {}
    for key, entry in index.items():
        kind = entry.get("kind")
        if kind == "none":
            flat[key] = None
        elif kind == "dense":
            flat[key] = dense[key]
        elif kind == "sharded":
            flat[key] = _load_sharded(dir_path, key, entry)
        else:
            raise ValueError(f"{dir_path}/index.json: {key} has unknown kind {kind!r}")
    tree = _unflatten(flat)
    if "__leaf__" in tree and len(tree) == 1:
        return tree["__leaf__"]
    return tree
