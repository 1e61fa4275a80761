"""Synthetic data: Toss-shaped Parquet files, and shard caches written
straight from NumPy.

``make_synth_frame``, ``write_synth_parquet`` and
``write_synth_train_test`` are the port of ``tossctr_tpu/data/synth.py``
(the same seeded draws, so the same tables): categorical columns
(``inventory_id``, ``gender``, ``age_group``, ...), ``feat_*`` and
``history_*`` numerics with missing values, a comma-separated ``seq``
column, the ``clicked`` label from a planted logistic model, and a string
``ID``; the Parquet ETL (``data/etl.py``) turns them into a cache.
pyarrow is imported by the writers alone.

``write_synth_cache`` is scaffolding for tests and ``chip_smoke.py`` (the
card's machine has no pyarrow): a seeded cache in the ``manifest.json``
+ NPY-shard format of the ETL (arrays X_num f32, X_mask u8, X_cat i32,
seq i32, y i8, groups i64, ids U64), without Parquet.  Sequences are
right-aligned and left-padded with ``pad_id`` like the ETL's; row
lengths run from 0 (all pad) to ``seq_len``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def make_synth_frame(
    n_rows: int,
    *,
    seed: int = 0,
    n_inventory: int = 200,
    n_l_feats: int = 4,
    n_num_feats: int = 6,
    n_history: int = 4,
    seq_vocab: int = 5000,
    seq_len_max: int = 80,
    missing_rate: float = 0.15,
    id_prefix: str = "TEST",
) -> Dict[str, np.ndarray]:
    """The columns of ``n_rows`` synthetic rows, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    inv = rng.integers(1, n_inventory + 1, n_rows)
    gender = rng.choice(["M", "F", "U"], n_rows)
    age = rng.choice(["10", "20", "30", "40", "50", "60"], n_rows)
    dow = rng.integers(0, 7, n_rows)
    hour = rng.integers(0, 24, n_rows)

    cols: Dict[str, np.ndarray] = {
        "ID": np.array([f"{id_prefix}_{i:08d}" for i in range(n_rows)]),
        "gender": gender,
        "age_group": age,
        "inventory_id": inv.astype(np.int64),
        "day_of_week": dow.astype(np.int64),
        "hour": hour.astype(np.int64),
    }
    for j in range(1, n_l_feats + 1):
        cols[f"l_feat_{j}"] = rng.integers(0, 50, n_rows).astype(np.int64)

    logits = -3.0 + 0.0 * inv
    for j in range(1, n_num_feats + 1):
        x = rng.normal(0, 1, n_rows)
        miss = rng.random(n_rows) < missing_rate
        w = rng.normal(0, 0.35)
        logits = logits + w * np.where(miss, 0.0, x)
        xf = x.copy()
        xf[miss] = np.nan
        cols[f"feat_a_{j}"] = xf
    for j in range(1, n_history + 1):
        x = np.abs(rng.normal(0, 1, n_rows))
        miss = rng.random(n_rows) < missing_rate / 2
        xf = x.copy()
        xf[miss] = np.nan
        cols[f"history_a_{j}"] = xf

    # behaviour sequences: each user has a preference cluster of tokens;
    # positives tend to have their inventory's token in the recent tail.
    inv_token = (inv * 13) % seq_vocab + 1
    seqs: List[str] = []
    seq_match = np.zeros(n_rows)
    lens = rng.integers(3, seq_len_max, n_rows)
    for i in range(n_rows):
        L = int(lens[i])
        toks = rng.integers(1, seq_vocab, L)
        if rng.random() < 0.35:
            # plant the inventory token near the end
            pos = L - 1 - int(rng.integers(0, min(5, L)))
            toks[pos] = inv_token[i]
            seq_match[i] = 1.0
        seqs.append(",".join(map(str, toks)))
    cols["seq"] = np.array(seqs)
    logits = logits + 1.6 * seq_match + 0.25 * (gender == "F")
    p = 1 / (1 + np.exp(-logits))
    cols["clicked"] = (rng.random(n_rows) < p).astype(np.int8)
    return cols


def write_synth_parquet(
    path: str, n_rows: int, *, seed: int = 0, include_label: bool = True, **kw
) -> str:
    """``make_synth_frame`` as one Parquet file (without ``clicked`` unless
    ``include_label``); returns ``path``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = make_synth_frame(n_rows, seed=seed, **kw)
    if not include_label:
        cols.pop("clicked")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    table = pa.table({k: pa.array(v) for k, v in cols.items()})
    pq.write_table(table, path)
    return path


def write_synth_train_test(
    out_dir: str,
    n_train: int = 20_000,
    n_test: int = 4_000,
    seed: int = 0,
    **kw,
) -> Dict[str, str]:
    """``train.parquet`` (ids TRAIN_*, labelled, ``seed``) and
    ``test.parquet`` (ids TEST_*, no label, ``seed + 1``) in ``out_dir``."""
    train = write_synth_parquet(
        os.path.join(out_dir, "train.parquet"), n_train, seed=seed, id_prefix="TRAIN", **kw
    )
    test = write_synth_parquet(
        os.path.join(out_dir, "test.parquet"),
        n_test,
        seed=seed + 1,
        include_label=False,
        id_prefix="TEST",
        **kw,
    )
    return {"train": train, "test": test}


def _save_shard(shard_dir: str, arrays) -> dict:
    os.makedirs(shard_dir, exist_ok=True)
    meta = {}
    for k, v in arrays.items():
        path = os.path.join(shard_dir, f"{k}.npy")
        np.save(path, v)
        meta[k] = {"path": path, "shape": list(v.shape), "dtype": str(v.dtype)}
    meta["rows"] = int(arrays["seq"].shape[0])
    return meta


def synth_arrays(rows: int, *, num_dim: int, cat_cards: Sequence[int], seq_len: int,
                 seq_vocab: int, pad_id: int = 0, seed: int = 0, row0: int = 0):
    """One shard's arrays; ids are ``TEST_<global row>``."""
    rng = np.random.default_rng(seed)
    x_num = rng.normal(0.0, 1.0, (rows, num_dim)).astype(np.float32)
    x_mask = (rng.random((rows, num_dim)) < 0.15).astype(np.uint8)
    x_num[x_mask.astype(bool)] = 0.0  # median impute of a zero-mean column
    x_cat = np.stack(
        [rng.integers(0, c, rows) for c in cat_cards], axis=1
    ).astype(np.int32) if len(cat_cards) else np.zeros((rows, 0), np.int32)
    lens = rng.integers(0, seq_len + 1, rows)
    toks = rng.integers(1, seq_vocab, (rows, seq_len)).astype(np.int32)
    toks[toks == pad_id] = pad_id + 1 if pad_id + 1 < seq_vocab else 1
    pos = np.arange(seq_len)[None, :]
    seq = np.where(pos >= (seq_len - lens)[:, None], toks, pad_id).astype(np.int32)
    return {
        "X_num": x_num,
        "X_mask": x_mask,
        "X_cat": x_cat,
        "seq": seq,
        "y": (rng.random(rows) < 0.05).astype(np.int8),
        "groups": rng.integers(0, 2**31 - 1, rows).astype(np.int64),
        "ids": np.array([f"TEST_{row0 + i:08d}" for i in range(rows)], dtype="U64"),
    }


def write_synth_cache(out_dir: str, rows: int, *, num_dim: int,
                      cat_cols: Sequence[str], cat_cards: Sequence[int],
                      seq_len: int, seq_vocab: int, pad_id: int = 0,
                      shard_rows: int = 2_000_000, seed: int = 0) -> str:
    """Write ``rows`` synthetic rows as shards of ``shard_rows``; returns
    the manifest path.  Each shard draws from ``seed + shard index``."""
    if len(cat_cols) != len(cat_cards):
        raise ValueError("cat_cols and cat_cards differ in length")
    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "is_train": False,
        "rows": 0,
        "shards": [],
        "num_cols": [f"feat_{j}" for j in range(num_dim)],
        "cat_cols": list(cat_cols),
        "seq_col": "seq",
    }
    for si, start in enumerate(range(0, rows, shard_rows)):
        n = min(shard_rows, rows - start)
        arrays = synth_arrays(
            n, num_dim=num_dim, cat_cards=cat_cards, seq_len=seq_len,
            seq_vocab=seq_vocab, pad_id=pad_id, seed=seed + si, row0=start,
        )
        meta = _save_shard(os.path.join(out_dir, f"shard_{si:03d}"), arrays)
        meta.update(index=si, start=start, end=start + n)
        manifest["shards"].append(meta)
        manifest["rows"] += n
    path = os.path.join(out_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def write_synth_cache_for(cfg, out_dir: str, rows: int, *, num_dim: int,
                          shard_rows: int = 2_000_000, seed: int = 0) -> str:
    """``write_synth_cache`` with the columns, cardinalities, sequence
    length, vocabulary and pad id of a Config."""
    cols = list(cfg.data.cat_cols)
    return write_synth_cache(
        out_dir, rows, num_dim=num_dim, cat_cols=cols,
        cat_cards=[cfg.data.bucket_for(c) for c in cols],
        seq_len=cfg.sequence.max_len, seq_vocab=int(cfg.model.seq_vocab),
        pad_id=cfg.sequence.pad_id, shard_rows=shard_rows, seed=seed,
    )
