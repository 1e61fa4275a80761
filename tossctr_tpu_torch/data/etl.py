"""Offline ETL: streaming Parquet -> fixed-shape NPY shard cache.

Port of ``tossctr_tpu/data/etl.py``, written to give byte-equal caches:
the same on-disk contract, ``shard_NNN/{X_num,X_mask,X_cat,seq,y,groups,ids}.npy``
plus a ``manifest.json`` with each shard's path / shape / dtype / rows /
start / end, which ``data/dataset.py`` reads.  Label cast to int8, CV
groups ``stable_hash % (2**31 - 1)`` with the composite group x time
option, string IDs as U64, per-column bucket + margin categorical
hashing with "NA" null fill (``utils/hashing.py``), exact medians with
isna masks and +-1e6 ``nan_to_num``, right-aligned sequences keeping the
last ``max_len`` non-empty tokens, exact ``shard_rows`` cuts, and the
optional covis feature join (``features/covis.py``).

pyarrow is imported inside the functions that read Parquet (``arrow``):
importing this module loads none of it, and a build on a machine
without it raises an ImportError that names it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.hashing import hash_group_ids, hash_to_buckets


def arrow():
    """-> (pyarrow, pyarrow.compute, pyarrow.dataset), or an ImportError
    that names pyarrow."""
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.dataset as ds
    except ImportError as e:
        raise ImportError(
            "the Parquet ETL needs pyarrow, which this Python does not have: build the "
            "shard cache on a host with pyarrow and pandas, then copy the cache") from e
    return pa, pc, ds


def _match_patterns(cols: List[str], patterns: List[str]) -> List[str]:
    """Glob-ish column selection (reference: build_cache_v1.py:11-16) —
    dedup-preserving, sorted."""
    out: List[str] = []
    for p in patterns:
        regex = re.compile("^" + p.replace("*", ".*") + "$")
        out += [c for c in cols if regex.match(c)]
    return sorted(dict.fromkeys(out))


def _ensure_dir(p: str) -> None:
    os.makedirs(p, exist_ok=True)


# --------------------------------------------------------------------------
# Schema / statistics pre-pass
# --------------------------------------------------------------------------


def analyze_schema_and_stats(
    parquet_path: str,
    target_col: Optional[str],
    seq_col: str,
    cat_cols: List[str],
    num_patterns: List[str],
    group_key: str,
    impute_strategy: str,
    num_cols_explicit: Optional[List[str]] = None,
    remove_cols: Optional[List[str]] = None,
) -> Dict:
    """Column inventory + exact global medians + row count
    (reference: build_cache_v1.py:31-75)."""
    _, _, ds = arrow()
    dataset = ds.dataset(parquet_path, format="parquet")
    cols = dataset.schema.names
    if num_cols_explicit:
        num_cols = [c for c in num_cols_explicit if c in cols]
    else:
        num_cols = [
            c
            for c in _match_patterns(cols, num_patterns)
            if c not in cat_cols
            and c not in [target_col, seq_col, group_key, "ID"]
            and c in cols
        ]
    if remove_cols:
        num_cols = [c for c in num_cols if c not in remove_cols]

    med_map: Dict[str, float] = {}
    if impute_strategy == "median" and num_cols:
        # Exact medians, one column at a time to bound memory (a single
        # float64 column of 10M rows is 80 MB).
        for c in num_cols:
            col = dataset.to_table(columns=[c])[c].to_numpy(zero_copy_only=False)
            col = col.astype(np.float64, copy=False)
            finite = col[~np.isnan(col)] if col.size else col
            v = float(np.median(finite)) if finite.size else float("nan")
            med_map[c] = 0.0 if (v != v) else v
    else:
        med_map = {c: 0.0 for c in num_cols}

    n_rows = dataset.count_rows()
    return {"all_cols": cols, "num_cols": num_cols, "med_map": med_map, "n_rows": int(n_rows)}


# --------------------------------------------------------------------------
# Vectorized sequence tokenization
# --------------------------------------------------------------------------


def tokenize_sequences(
    strings: np.ndarray, max_len: int, pad_id: int = 0
) -> np.ndarray:
    """Comma-separated token strings -> right-aligned (N, max_len) int32,
    left-padded with ``pad_id``, keeping the LAST ``max_len`` tokens
    (reference semantics: build_cache_v1.py:149-156), fully vectorized.
    """
    n = len(strings)
    out = np.full((n, max_len), pad_id, dtype=np.int32)
    if n == 0:
        return out
    pa, pc, _ = arrow()
    arr = pa.array(
        ["" if s is None else str(s) for s in strings], type=pa.string()
    )
    parts = pc.split_pattern(arr, ",")  # ListArray of strings
    flat = parts.values.to_numpy(zero_copy_only=False)  # all tokens, row-major
    offsets = parts.offsets.to_numpy().astype(np.int64)
    lens = np.diff(offsets)
    # token -> owning row
    row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
    # Filter empty tokens BEFORE alignment (reference does per-token
    # `if x`, build_cache_v1.py:153): a mid-string empty token ("1,,2")
    # or trailing comma must not shift the right-alignment or displace
    # valid tokens from the keep window.  Rank every token among its
    # row's *non-empty* tokens via a global cumsum.
    nonempty = flat != ""
    cs = np.cumsum(nonempty)
    cse = np.concatenate([np.zeros(1, np.int64), cs])
    vcount = cse[offsets[1:]] - cse[offsets[:-1]]  # valid tokens per row
    rank = cs - 1 - np.repeat(cse[offsets[:-1]], lens)  # 0-based valid rank
    vc_rep = np.repeat(vcount, lens)
    # keep the last max_len valid tokens; right-align on valid count
    kept = nonempty & (rank >= vc_rep - max_len)
    col = max_len - (vc_rep - rank)
    r, c = row_of[kept], col[kept]
    vals = flat[kept]
    if vals.size:
        out[r, c] = np.array(vals, dtype=np.int64).astype(np.int32)
    return out


# --------------------------------------------------------------------------
# Per-batch processing
# --------------------------------------------------------------------------


def _col_to_numpy(table: "pa.Table", name: str) -> np.ndarray:
    return table[name].to_numpy(zero_copy_only=False)


def process_batch(
    table: "pa.Table",
    *,
    is_train: bool,
    target_col: Optional[str],
    seq_col: str,
    cat_cols: List[str],
    hash_buckets: Dict[str, int],
    hash_buckets_margin: int,
    default_hash_bucket: int,
    num_cols: List[str],
    med_map: Dict[str, float],
    max_len: int,
    pad_id: int,
    group_key: str,
    time_key: Optional[str] = None,
    composite_group: bool = False,
    hash_seed: int = 2025,
) -> Dict[str, np.ndarray]:
    """One record-batch -> the 7 cache arrays
    (reference: build_cache_v1.py:79-166)."""
    cols = table.column_names
    n = table.num_rows

    # ---- label ----
    if is_train and target_col in cols:
        y = _col_to_numpy(table, target_col)
        y = np.nan_to_num(y.astype(np.float64), nan=0.0).astype(np.int8)
    else:
        y = np.zeros((n,), np.int8)

    # ---- CV groups: stable hash % (2**31 - 1), optionally group×time ----
    if composite_group and group_key in cols and time_key and time_key in cols:
        groups = hash_group_ids(
            _col_to_numpy(table, group_key), _col_to_numpy(table, time_key), seed=hash_seed
        )
    elif group_key in cols:
        groups = hash_group_ids(_col_to_numpy(table, group_key), seed=hash_seed)
    else:
        groups = np.zeros((n,), np.int64)

    # ---- IDs kept as strings for the submission format ----
    if "ID" in cols:
        raw = _col_to_numpy(table, "ID")
        ids = np.array(["" if v is None else str(v) for v in raw], dtype="U64")
    else:
        ids = np.arange(n).astype(str).astype("U64")

    # ---- hashed categoricals ----
    xs = []
    for c in cat_cols:
        hb = int(hash_buckets.get(c, default_hash_bucket)) + int(hash_buckets_margin)
        if c in cols:
            xs.append(hash_to_buckets(_col_to_numpy(table, c), hb, seed=hash_seed))
        else:
            xs.append(np.zeros((n,), np.int32))
    X_cat = np.stack(xs, axis=1).astype(np.int32) if xs else np.zeros((n, 0), np.int32)

    # ---- numeric + isna mask + median impute ----
    if num_cols:
        X_num = np.empty((n, len(num_cols)), np.float32)
        for j, c in enumerate(num_cols):
            if c in cols:
                X_num[:, j] = _col_to_numpy(table, c).astype(np.float32, copy=False)
            else:
                X_num[:, j] = np.nan
        mask = np.isnan(X_num).astype(np.uint8)
        for j, c in enumerate(num_cols):
            mj = mask[:, j].astype(bool)
            if mj.any():
                X_num[mj, j] = med_map.get(c, 0.0)
        np.nan_to_num(X_num, copy=False, nan=0.0, posinf=1e6, neginf=-1e6)
    else:
        X_num = np.zeros((n, 0), np.float32)
        mask = np.zeros((n, 0), np.uint8)

    # ---- sequence ----
    if seq_col in cols:
        seq = tokenize_sequences(_col_to_numpy(table, seq_col), max_len, pad_id)
    else:
        seq = np.full((n, max_len), pad_id, dtype=np.int32)

    return {
        "X_num": X_num,
        "X_mask": mask,
        "X_cat": X_cat,
        "seq": seq,
        "y": y,
        "groups": groups,
        "ids": ids,
    }


# --------------------------------------------------------------------------
# Shard writer
# --------------------------------------------------------------------------

_ARRAY_KEYS = ["X_num", "X_mask", "X_cat", "seq", "y", "groups", "ids"]


def _save_shard(shard_dir: str, arrays: Dict[str, np.ndarray]) -> Dict:
    _ensure_dir(shard_dir)
    meta: Dict = {}
    for k, v in arrays.items():
        path = os.path.join(shard_dir, f"{k}.npy")
        np.save(path, v)
        meta[k] = {"path": path, "shape": list(v.shape), "dtype": str(v.dtype)}
    meta["rows"] = int(arrays["seq"].shape[0])
    return meta


def build_sharded_cache(
    parquet_path: str,
    out_dir: str,
    *,
    is_train: bool,
    target_col: Optional[str],
    seq_col: str,
    cat_cols: List[str],
    hash_buckets: Dict[str, int],
    hash_buckets_margin: int,
    num_patterns: List[str],
    max_len: int,
    pad_id: int,
    group_key: str,
    time_key: Optional[str] = None,
    composite_group: bool = False,
    shard_rows: int = 2_000_000,
    stream_batch_rows: int = 200_000,
    impute_strategy: str = "median",
    num_cols_explicit: Optional[List[str]] = None,
    remove_cols: Optional[List[str]] = None,
    default_hash_bucket: int = 1_000_003,
    hash_seed: int = 2025,
    covis_dir: Optional[str] = None,
    progress: bool = False,
) -> str:
    """Parquet -> NPY shards + manifest.json; returns the manifest path
    (reference: build_cache_v1.py:179-307; covis join: v2:177-286)."""
    pa, _, ds = arrow()
    _ensure_dir(out_dir)
    schema = analyze_schema_and_stats(
        parquet_path,
        target_col,
        seq_col,
        cat_cols,
        num_patterns,
        group_key,
        impute_strategy,
        num_cols_explicit,
        remove_cols,
    )
    num_cols: List[str] = schema["num_cols"]
    med_map: Dict[str, float] = dict(schema["med_map"])
    total_n = schema["n_rows"]

    covis = None
    if covis_dir:
        from ..features.covis import CovisJoiner

        covis = CovisJoiner(covis_dir, is_train=is_train)
        num_cols = num_cols + covis.feature_names
        med_map.update({c: 0.0 for c in covis.feature_names})

    dataset = ds.dataset(parquet_path, format="parquet")
    scanner = dataset.scanner(batch_size=stream_batch_rows)

    manifest = {
        "parquet": parquet_path,
        "is_train": is_train,
        "rows": 0,
        "shards": [],
        "num_cols": num_cols,
        "cat_cols": cat_cols,
        "group_key": group_key,
        "seq_col": seq_col,
    }
    shard_idx = 0
    acc: Dict[str, List[np.ndarray]] = {k: [] for k in _ARRAY_KEYS}
    row_buf = 0
    rid_base = 0  # global row id for covis OOF join (reference v2:269-272)

    def emit(arrays: Dict[str, np.ndarray]) -> None:
        nonlocal shard_idx
        sdir = os.path.join(out_dir, f"shard_{shard_idx:03d}")
        meta = _save_shard(sdir, arrays)
        meta["index"] = shard_idx
        meta["start"] = manifest["rows"]
        meta["end"] = manifest["rows"] + meta["rows"]
        manifest["shards"].append(meta)
        manifest["rows"] += meta["rows"]
        shard_idx += 1
        if progress:
            print(f"  shard {meta['index']:03d}: rows {meta['start']}..{meta['end']}")

    for rb in scanner.to_batches():
        table = pa.Table.from_batches([rb])
        if remove_cols:
            keep = [c for c in table.column_names if c not in remove_cols]
            table = table.select(keep)
        batch = process_batch(
            table,
            is_train=is_train,
            target_col=target_col,
            seq_col=seq_col,
            cat_cols=cat_cols,
            hash_buckets=hash_buckets,
            hash_buckets_margin=hash_buckets_margin,
            default_hash_bucket=default_hash_bucket,
            num_cols=[c for c in num_cols if covis is None or c not in covis.feature_names],
            med_map=med_map,
            max_len=max_len,
            pad_id=pad_id,
            group_key=group_key,
            time_key=time_key,
            composite_group=composite_group,
            hash_seed=hash_seed,
        )
        if covis is not None:
            feats = covis.features_for(
                rid_base=rid_base, n=table.num_rows, ids=batch["ids"]
            )
            batch["X_num"] = np.concatenate([batch["X_num"], feats], axis=1)
            covis_mask = np.zeros((table.num_rows, len(covis.feature_names)), np.uint8)
            batch["X_mask"] = np.concatenate([batch["X_mask"], covis_mask], axis=1)
        rid_base += table.num_rows

        for k in _ARRAY_KEYS:
            acc[k].append(batch[k])
        row_buf += table.num_rows

        while row_buf >= shard_rows:
            cat = {k: np.concatenate(acc[k], axis=0) for k in _ARRAY_KEYS}
            emit({k: cat[k][:shard_rows] for k in _ARRAY_KEYS})
            acc = {k: [cat[k][shard_rows:]] for k in _ARRAY_KEYS}
            row_buf -= shard_rows

    if row_buf > 0:
        emit({k: np.concatenate(acc[k], axis=0) for k in _ARRAY_KEYS})

    assert manifest["rows"] == total_n, (manifest["rows"], total_n)
    man_path = os.path.join(out_dir, "manifest.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return man_path


def build_train_and_test(cfg) -> Tuple[str, str]:
    """Entry helper mirroring reference build_cache_v1.py:310-351.
    ``cfg`` is a tossctr_tpu_torch Config."""
    d, s, c = cfg.data, cfg.sequence, cfg.cv
    covis_dir = (cfg.features or {}).get("covis", {}).get("out_dir")
    common = dict(
        seq_col=s.col,
        cat_cols=d.cat_cols,
        hash_buckets=d.hash_buckets,
        hash_buckets_margin=d.hash_buckets_margin,
        num_patterns=d.num_patterns,
        num_cols_explicit=d.num_cols_explicit,
        max_len=s.max_len,
        pad_id=s.pad_id,
        group_key=c.group_key,
        time_key=c.time_key,
        composite_group=bool(c.composite_group),
        shard_rows=d.shard_rows,
        stream_batch_rows=d.stream_batch_rows,
        impute_strategy=d.impute_strategy,
        remove_cols=d.remove_cols,
        default_hash_bucket=d.default_hash_bucket,
        covis_dir=covis_dir,
    )
    mp_train = build_sharded_cache(
        d.train_path,
        os.path.join(d.cache_dir, "train"),
        is_train=True,
        target_col=cfg.cv.stratify_target or "clicked",
        **common,
    )
    mp_test = build_sharded_cache(
        d.test_path,
        os.path.join(d.cache_dir, "test"),
        is_train=False,
        target_col=None,
        **common,
    )
    return mp_train, mp_test
