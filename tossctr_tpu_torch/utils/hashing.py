"""Stable, host-independent, vectorized string hashing.

Port of ``tossctr_tpu/utils/hashing.py``, kept bit-equal to it: a 64-bit
FNV-1a over the UTF-8 bytes of each value's string form, mixed with a
seed and finalized with a splitmix64 avalanche.  The string form follows
the reference's ``cast(Utf8).fill_null("NA")``: ints print as ints,
integral floats as ints ("3", not "3.0"), other floats as ``repr``, None
and NaN as ``"NA"``, and the strings are cut at the fixed widths ``U32``
(ints) and ``U64`` (floats, strings, objects) before hashing.  Used for
the cache's categorical buckets and CV groups (``data/etl.py``), the
covis folds (``features/covis.py``) and the collision audit
(``tools/check_hash_collisions.py``).
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

DEFAULT_SEED = 2025


def _splitmix64(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def _to_utf8_strings(values: np.ndarray, null_token: str = "NA") -> np.ndarray:
    """Cast arbitrary values to their string form, mapping nulls to ``null_token``.

    Mirrors the reference's ``cast(Utf8).fill_null("NA")``: floats print in a
    canonical form, ints as ints, strings pass through.
    """
    values = np.asarray(values)
    if values.dtype.kind in "iu":
        return values.astype("U32")
    if values.dtype.kind == "f":
        out = np.empty(values.shape, dtype=object)
        nan_mask = np.isnan(values)
        # Integral floats print as ints ("3" not "3.0") — categorical columns
        # stored as float in parquet are almost always integral codes.
        ints = np.nan_to_num(values, nan=0.0).astype(np.int64)
        integral = ~nan_mask & (values == ints)
        out[integral] = ints[integral].astype("U32")
        rest = ~nan_mask & ~integral
        if rest.any():
            out[rest] = np.array([repr(float(v)) for v in values[rest]], dtype=object)
        out[nan_mask] = null_token
        return out.astype("U64")
    # strings / objects — canonicalize integral floats like the float branch
    # ("42.0" -> "42") so mixed-type object columns stay self-consistent.
    out = np.empty(values.shape, dtype=object)
    flat = out.ravel()
    for i, v in enumerate(values.ravel()):
        if v is None or (isinstance(v, float) and v != v):
            flat[i] = null_token
        elif isinstance(v, float) and v == int(v):
            flat[i] = str(int(v))
        else:
            flat[i] = str(v)
    return out.reshape(values.shape).astype("U64")


def stable_hash64(values: np.ndarray, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Vectorized 64-bit stable hash of the string form of ``values``.

    Returns uint64 of the same shape.
    """
    strs = _to_utf8_strings(values)
    # Encode to fixed-width bytes; itemsize gives max width.
    b = np.char.encode(strs, "utf-8")
    width = max(1, b.dtype.itemsize)
    mat = b.view(np.uint8).reshape(-1, width)  # zero-padded byte matrix
    n = mat.shape[0]
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    h ^= _splitmix64(np.full(n, np.uint64(seed), dtype=np.uint64))
    alive = np.ones(n, dtype=bool)
    with np.errstate(over="ignore"):
        for j in range(width):
            col = mat[:, j]
            alive &= col != 0  # stop at the first NUL padding byte
            if not alive.any():
                break
            hj = (h ^ col.astype(np.uint64)) * _FNV_PRIME
            h = np.where(alive, hj, h)
    return _splitmix64(h).reshape(strs.shape)


def hash_to_buckets(
    values: np.ndarray, buckets: int, seed: int = DEFAULT_SEED
) -> np.ndarray:
    """Hash values into ``[0, buckets)`` as int32 (reference: hashed
    categorical columns, build_cache_v1.py:124-133)."""
    return (stable_hash64(values, seed) % np.uint64(buckets)).astype(np.int32)


def hash_group_ids(
    values: np.ndarray,
    time_values: np.ndarray | None = None,
    seed: int = DEFAULT_SEED,
) -> np.ndarray:
    """Group ids for CV splitting: ``hash % (2**31 - 1)`` as int64, with the
    optional composite group×time hashing (build_cache_v1.py:101-116)."""
    if time_values is not None:
        h = stable_hash64(values, seed) ^ _splitmix64(
            stable_hash64(time_values, seed + 1)
        )
    else:
        h = stable_hash64(values, seed)
    return (h % np.uint64(2**31 - 1)).astype(np.int64)
