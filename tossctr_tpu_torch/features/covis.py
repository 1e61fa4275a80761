"""Co-visitation CTR features: leakage-safe (token x target) statistics.

Port of ``tossctr_tpu/features/covis.py``, written to give the same
Parquet outputs, column by column:
  1. ``make_folds``: group ids (the cache's stable hash, with the
     composite group x time option) get folds round-robin over the sorted
     unique hashes, an approximate GroupKFold.
  2. Pair statistics: each row's last ``seq_top_k`` tokens, with recency
     weight ``exp(-(L-1-pos)/tau)``, grouped by (token, target[,
     time_bin]): impressions, clicks, recency-weight sum, and the
     beta-smoothed CTR ``(clicks + p0*S)/(impr + S)`` clipped to
     ``ctr_clip``, with a low-count flag.  The full-train tables feed the
     test features; per-fold out-of-fold tables (every fold but f) feed
     the train features, summed from per-fold partials.
  3. Row features: each row's tokens joined against the pair table and
     aggregated (sum / mean / max / top-n mean / recency-weighted mean /
     p-norm of the CTR, sum / max of impressions).

Artifacts: ``rowfeat_oof_all.parquet`` (train, keyed by the global row id
``rid``) and ``rowfeat_test.parquet`` (keyed by ``ID``), which the cache
build joins (``data/etl.py`` ``covis_dir``, ``CovisJoiner``).

``CovisConfig.from_cfg`` reads only the keys of ``features.covis`` that
are the dataclass's field names, as the JAX package does.  pandas and
pyarrow are imported inside the functions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.etl import arrow, tokenize_sequences
from ..utils.hashing import hash_group_ids


@dataclass
class CovisConfig:
    targets: List[str] = field(default_factory=lambda: ["inventory_id"])
    time_bin: Optional[str] = None  # e.g. "day_of_week"
    seq_col: str = "seq"
    target_col: str = "clicked"
    seq_top_k: int = 120
    recency_tau: float = 512.0
    prior_strength: float = 50.0
    min_impr: int = 10
    ctr_clip: Tuple[float, float] = (1e-4, 0.9)
    top_n: int = 10
    p_norm: float = 2.0
    n_folds: int = 5
    group_key: str = "inventory_id"
    time_key: Optional[str] = None
    composite_group: bool = False
    out_dir: str = "./cache/covis"
    stream_batch_rows: int = 200_000

    @classmethod
    def from_cfg(cls, cfg) -> "CovisConfig":
        f = (cfg.features or {}).get("covis", {}) or {}
        known = {k: v for k, v in f.items() if k in cls.__dataclass_fields__}
        obj = cls(**known)
        obj.n_folds = max(5, int(cfg.cv.n_splits))
        obj.group_key = cfg.cv.group_key
        obj.time_key = cfg.cv.time_key
        obj.composite_group = bool(cfg.cv.composite_group)
        return obj


def make_folds(groups: np.ndarray, n_folds: int) -> np.ndarray:
    """Round-robin fold id per row from sorted unique group hashes —
    the reference's approximate GroupKFold (covis.py:117-150)."""
    uniq = np.unique(groups)
    fold_of_group = {g: i % n_folds for i, g in enumerate(uniq)}
    return np.array([fold_of_group[g] for g in groups], dtype=np.int32)


def _feature_names(target: str, top_n: int) -> List[str]:
    base = f"covis_{target}"
    return [
        f"{base}_ctr_sum",
        f"{base}_ctr_mean",
        f"{base}_ctr_max",
        f"{base}_ctr_top{top_n}_mean",
        f"{base}_ctr_wmean",
        f"{base}_ctr_pnorm",
        f"{base}_impr_sum",
        f"{base}_impr_max",
    ]


def _explode_tokens(
    seq_strings: np.ndarray, top_k: int, tau: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (row_of_token, token, recency_weight) over the last top_k tokens."""
    toks = tokenize_sequences(seq_strings, max_len=top_k, pad_id=0)
    n, k = toks.shape
    valid = toks != 0
    row_of = np.repeat(np.arange(n, dtype=np.int64), valid.sum(axis=1))
    token = toks[valid].astype(np.int64)
    # position k-1 is the most recent; weight exp(-(k-1-pos)/tau)
    pos = np.broadcast_to(np.arange(k), (n, k))[valid]
    w = np.exp(-(k - 1 - pos) / max(1.0, float(tau)))
    return row_of, token, w


class _PairStatsAccumulator:
    """Streaming groupby over (fold, token, target_value[, time_bin])."""

    # compact the pending partials once they hold this many rows: dense
    # batches barely deduplicate per batch (~0.7 unique pairs per
    # exploded token), so a batch-count threshold lets partials pile up
    # O(n_batches x batch_pairs) (~45 MB each, measured); a row bound
    # caps the resident set regardless of batch density.  600k bounds the
    # concat+groupby temp at each compaction, what sets the peak RSS once the
    # unique-key base saturates (the JAX package's
    # exp/covis_rss_anatomy.py), for ~1 extra compaction per 2 batches at
    # dense shapes.
    COMPACT_ROWS = 600_000

    def __init__(self, with_time: bool):
        self.with_time = with_time
        self.parts: List["pd.DataFrame"] = []
        self._pending_rows = 0

    def add(
        self,
        fold: np.ndarray,
        token: np.ndarray,
        tgt: np.ndarray,
        tb: Optional[np.ndarray],
        y: np.ndarray,
        w: np.ndarray,
    ) -> None:
        import pandas as pd

        df = pd.DataFrame({"fold": fold, "token": token, "tgt": tgt})
        keys = ["fold", "token", "tgt"]
        if self.with_time:
            df["tb"] = tb
            keys.append("tb")
        df["impr"] = 1.0
        df["clicks"] = y.astype(np.float64)
        df["w_rec"] = w
        part = df.groupby(keys, sort=False, as_index=False).sum()
        del df
        self.parts.append(part)
        self._pending_rows += len(part)
        # incremental compaction: without it the per-batch partials pile up
        # and finalize pays one O(batches x unique keys) concat+groupby;
        # compacting on a row bound keeps resident partials O(unique keys +
        # COMPACT_ROWS)
        if len(self.parts) > 1 and self._pending_rows >= self.COMPACT_ROWS:
            self.parts = [
                pd.concat(self.parts, ignore_index=True)
                .groupby(keys, sort=False, as_index=False)
                .sum()
            ]
            # count only rows accumulated BEYOND the compacted base, so a
            # base bigger than the threshold can't force a compaction
            # per batch (resident set = base + up to COMPACT_ROWS pending)
            self._pending_rows = 0
            _malloc_trim()

    def finalize(self) -> "pd.DataFrame":
        import pandas as pd

        keys = ["fold", "token", "tgt"] + (["tb"] if self.with_time else [])
        if not self.parts:
            return pd.DataFrame(columns=keys + ["impr", "clicks", "w_rec"])
        df = pd.concat(self.parts, ignore_index=True)
        return df.groupby(keys, sort=False, as_index=False).sum()


def _smooth_ctr(
    impr: np.ndarray, clicks: np.ndarray, p0: float, S: float, clip: Tuple[float, float]
) -> np.ndarray:
    ctr = (clicks + p0 * S) / (impr + S)
    return np.clip(ctr, clip[0], clip[1])


def _pair_table_from_folds(
    per_fold: "pd.DataFrame", exclude_fold: Optional[int], cfg: CovisConfig, p0: float
) -> "pd.DataFrame":
    """Aggregate per-fold partial sums into a pair table, optionally
    leaving one fold out (the OOF table for that fold)."""
    df = per_fold if exclude_fold is None else per_fold[per_fold["fold"] != exclude_fold]
    keys = ["token", "tgt"] + (["tb"] if "tb" in per_fold.columns else [])
    agg = df.groupby(keys, sort=False, as_index=False)[["impr", "clicks", "w_rec"]].sum()
    agg["ctr"] = _smooth_ctr(
        agg["impr"].to_numpy(),
        agg["clicks"].to_numpy(),
        p0,
        cfg.prior_strength,
        cfg.ctr_clip,
    )
    agg["low_count"] = (agg["impr"] < cfg.min_impr).astype(np.float32)
    return agg


def _row_features(
    row_of: np.ndarray,
    token: np.ndarray,
    tgt: np.ndarray,
    tb: Optional[np.ndarray],
    w: np.ndarray,
    n_rows: int,
    pair_tbl: "pd.DataFrame",
    cfg: CovisConfig,
) -> np.ndarray:
    """Aggregate joined pair stats per row -> (n_rows, 8) float32
    (reference covis.py:240-312, with the wmean denominator fixed)."""
    import pandas as pd

    keys = ["token", "tgt"] + (["tb"] if tb is not None else [])
    df = pd.DataFrame({"row": row_of, "token": token, "tgt": tgt, "w": w})
    if tb is not None:
        df["tb"] = tb
    m = df.merge(pair_tbl[keys + ["ctr", "impr"]], on=keys, how="left")
    hit = m["ctr"].notna().to_numpy()
    out = np.zeros((n_rows, 8), np.float32)
    if not hit.any():
        return out
    m = m[hit]
    row = m["row"].to_numpy()
    ctr = m["ctr"].to_numpy(np.float64)
    impr = m["impr"].to_numpy(np.float64)
    ww = m["w"].to_numpy(np.float64)

    cnt = np.bincount(row, minlength=n_rows).astype(np.float64)
    safe_cnt = np.maximum(cnt, 1.0)
    ctr_sum = np.bincount(row, weights=ctr, minlength=n_rows)
    out[:, 0] = ctr_sum
    out[:, 1] = ctr_sum / safe_cnt
    cmax = np.full(n_rows, -np.inf)
    np.maximum.at(cmax, row, ctr)
    out[:, 2] = np.where(np.isfinite(cmax), cmax, 0.0)
    # top-n mean per row: sort by (row, -ctr), rank within row, take first n
    order = np.lexsort((-ctr, row))
    r_sorted, c_sorted = row[order], ctr[order]
    first = np.r_[True, r_sorted[1:] != r_sorted[:-1]]
    rank = np.arange(r_sorted.size) - np.maximum.accumulate(
        np.where(first, np.arange(r_sorted.size), 0)
    )
    topn = rank < cfg.top_n
    tn_sum = np.bincount(r_sorted[topn], weights=c_sorted[topn], minlength=n_rows)
    tn_cnt = np.bincount(r_sorted[topn], minlength=n_rows).astype(np.float64)
    out[:, 3] = tn_sum / np.maximum(tn_cnt, 1.0)
    w_sum = np.bincount(row, weights=ww, minlength=n_rows)
    out[:, 4] = np.bincount(row, weights=ww * ctr, minlength=n_rows) / np.maximum(
        w_sum, 1e-12
    )
    p = cfg.p_norm
    out[:, 5] = (
        np.bincount(row, weights=np.abs(ctr) ** p, minlength=n_rows) / safe_cnt
    ) ** (1.0 / p)
    out[:, 6] = np.bincount(row, weights=impr, minlength=n_rows)
    imax = np.full(n_rows, -np.inf)
    np.maximum.at(imax, row, impr)
    out[:, 7] = np.where(np.isfinite(imax), imax, 0.0)
    return out


def _malloc_trim() -> None:
    """Return freed glibc arena pages to the OS.  The per-batch pandas
    merge/groupby churn in passes 2-3 leaves ~100 MB/1M-rows of freed-
    but-resident pages behind (measured in the JAX package); trimming after
    each batch caps resident (and therefore peak) RSS at
    O(stream_batch + unique pairs) for real.  ~50 us/call; no-op where
    glibc is unavailable."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def _phase_rss(phase: str) -> None:
    """Opt-in phase-boundary RSS logging (TOSSCTR_COVIS_RSS_LOG=1):
    one JSON line per phase to stderr with current and high-water RSS."""
    if not os.environ.get("TOSSCTR_COVIS_RSS_LOG"):
        return
    import json
    import resource
    import sys

    with open("/proc/self/statm") as f:
        rss_now = int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE") // 1024)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(
        json.dumps({"covis_rss_phase": phase, "rss_now_mb": rss_now / 1024.0,
                    "rss_peak_mb": peak / 1024.0}),
        file=sys.stderr, flush=True,
    )


def build_covis_features(
    train_parquet: str,
    test_parquet: Optional[str],
    cfg: CovisConfig,
) -> Dict[str, str]:
    """Full covis pipeline -> {'oof': rowfeat_oof_all.parquet,
    'test': rowfeat_test.parquet}."""
    pa, _, ds = arrow()
    import pyarrow.parquet as pq

    os.makedirs(cfg.out_dir, exist_ok=True)
    _phase_rss("start")
    dataset = ds.dataset(train_parquet, format="parquet")
    cols = [cfg.seq_col, cfg.target_col, cfg.group_key] + cfg.targets
    if cfg.time_bin:
        cols.append(cfg.time_bin)
    if cfg.composite_group and cfg.time_key:
        cols.append(cfg.time_key)
    cols = list(dict.fromkeys(c for c in cols if c in dataset.schema.names))

    # pass 1: fold assignment needs all group hashes.  Stream + hash in
    # batches: stable_hash64 stringifies its input (U32 = 128 B/row),
    # so hashing the whole column at once costs O(n_rows x 128 B) of
    # transient peak (measured +208 MB/1M rows); per-batch hashing keeps
    # only the 8 B/row hash output resident.
    composite = (
        cfg.composite_group and cfg.time_key
        and cfg.time_key in dataset.schema.names
    )
    gcols = [cfg.group_key] + ([cfg.time_key] if composite else [])
    ghashes = []
    for rb in dataset.scanner(
        columns=gcols, batch_size=cfg.stream_batch_rows
    ).to_batches():
        gv = rb.column(0).to_numpy(zero_copy_only=False)
        tv = rb.column(1).to_numpy(zero_copy_only=False) if composite else None
        ghashes.append(hash_group_ids(gv, tv))
    groups = np.concatenate(ghashes) if ghashes else np.zeros(0, np.int64)
    del ghashes
    folds = make_folds(groups, cfg.n_folds)
    _phase_rss("pass1_folds")

    def scan_exploded():
        """Stream (rid0, n, row_of, token, w, tbv, {target: values}, y)
        batch by batch.  Called once per pass — peak memory stays
        O(stream_batch_rows); nothing exploded is retained across batches
        (the reference kept lazy Polars scans for the same reason,
        covis.py:154-211)."""
        rid0 = 0
        for rb in dataset.scanner(
            columns=cols, batch_size=cfg.stream_batch_rows
        ).to_batches():
            n = rb.num_rows
            seq = rb.column(cols.index(cfg.seq_col)).to_numpy(zero_copy_only=False)
            y = np.nan_to_num(
                rb.column(cols.index(cfg.target_col))
                .to_numpy(zero_copy_only=False)
                .astype(np.float64)
            )
            row_of, token, w = _explode_tokens(seq, cfg.seq_top_k, cfg.recency_tau)
            tbv = None
            if cfg.time_bin:
                tb_col = rb.column(cols.index(cfg.time_bin)).to_numpy(zero_copy_only=False)
                tbv = np.asarray(tb_col)[row_of]
            tvals = {
                t: np.asarray(rb.column(cols.index(t)).to_numpy(zero_copy_only=False))
                for t in cfg.targets
            }
            yield rid0, n, row_of, token, w, tbv, tvals, y
            rid0 += n

    # pass 2: accumulate per-fold pair statistics per target
    acc = {t: _PairStatsAccumulator(with_time=cfg.time_bin is not None) for t in cfg.targets}
    pos_sum, n_sum = 0.0, 0
    for rid0, n, row_of, token, w, tbv, tvals, y in scan_exploded():
        batch_fold = folds[rid0 : rid0 + n]
        for t in cfg.targets:
            acc[t].add(batch_fold[row_of], token, tvals[t][row_of], tbv, y[row_of], w)
        pos_sum += float(y.sum())
        n_sum += n

    _phase_rss("pass2_accumulate")
    p0 = pos_sum / max(1, n_sum)  # global prior for beta smoothing
    per_fold = {t: acc[t].finalize() for t in cfg.targets}
    full_tbl = {t: _pair_table_from_folds(per_fold[t], None, cfg, p0) for t in cfg.targets}
    oof_tbl = {
        t: {f: _pair_table_from_folds(per_fold[t], f, cfg, p0) for f in range(cfg.n_folds)}
        for t in cfg.targets
    }
    _phase_rss("pair_tables")

    # pass 3: OOF row features for train (each row joined against the
    # table that excludes its own fold).  Re-scans the parquet instead of
    # caching pass 2's exploded tokens: at 10M rows x top-120 tokens the
    # cache would be tens of GB, while re-tokenizing a 200k-row batch is
    # deterministic and cheap.
    all_names: List[str] = []
    for t in cfg.targets:
        all_names += _feature_names(t, cfg.top_n)
    # Streaming write: one row-group per scan
    # batch instead of a full (n_rows, 8*n_targets) matrix in RAM —
    # peak memory is O(stream_batch), independent of row count/targets.
    oof_path = os.path.join(cfg.out_dir, "rowfeat_oof_all.parquet")
    writer: Optional["pq.ParquetWriter"] = None
    for rid_base, n, row_of, token, w, tbv, tvals, _y in scan_exploded():
        batch_fold = folds[rid_base : rid_base + n]
        fblock = np.zeros((n, len(all_names)), np.float32)
        for ti, t in enumerate(cfg.targets):
            tv = tvals[t][row_of]
            for f in np.unique(batch_fold):
                sel = batch_fold[row_of] == f
                sub = _row_features(
                    row_of[sel], token[sel], tv[sel],
                    None if tbv is None else tbv[sel],
                    w[sel], n, oof_tbl[t][int(f)], cfg,
                )
                rows_in_fold = batch_fold == f
                fblock[rows_in_fold, ti * 8 : (ti + 1) * 8] = sub[rows_in_fold]
        tbl = pa.table(
            {"rid": np.arange(rid_base, rid_base + n, dtype=np.int64),
             **{name: fblock[:, j] for j, name in enumerate(all_names)}}
        )
        if writer is None:
            writer = pq.ParquetWriter(oof_path, tbl.schema)
        writer.write_table(tbl)
        _malloc_trim()
    if writer is not None:
        writer.close()
    _phase_rss("pass3_oof")

    out = {"oof": oof_path}
    if test_parquet:
        tds = ds.dataset(test_parquet, format="parquet")
        tcols = [c for c in cols if c != cfg.target_col and c in tds.schema.names]
        if "ID" in tds.schema.names:
            tcols = ["ID"] + [c for c in tcols if c != "ID"]
        test_path = os.path.join(cfg.out_dir, "rowfeat_test.parquet")
        twriter: Optional["pq.ParquetWriter"] = None
        for rb in tds.scanner(columns=tcols, batch_size=cfg.stream_batch_rows).to_batches():
            n = rb.num_rows
            seq = rb.column(tcols.index(cfg.seq_col)).to_numpy(zero_copy_only=False)
            row_of, token, w = _explode_tokens(seq, cfg.seq_top_k, cfg.recency_tau)
            tbv = None
            if cfg.time_bin and cfg.time_bin in tcols:
                tbv = np.asarray(
                    rb.column(tcols.index(cfg.time_bin)).to_numpy(zero_copy_only=False)
                )[row_of]
            fblock = np.zeros((n, len(all_names)), np.float32)
            for ti, t in enumerate(cfg.targets):
                tv = np.asarray(
                    rb.column(tcols.index(t)).to_numpy(zero_copy_only=False)
                )[row_of]
                fblock[:, ti * 8 : (ti + 1) * 8] = _row_features(
                    row_of, token, tv, tbv, w, n, full_tbl[t], cfg
                )
            cols_out = {name: fblock[:, j] for j, name in enumerate(all_names)}
            if "ID" in tcols:
                ids = np.asarray(
                    rb.column(tcols.index("ID")).to_numpy(zero_copy_only=False)
                ).astype(str)
                cols_out = {"ID": ids, **cols_out}
            tbl = pa.table(cols_out)
            if twriter is None:
                twriter = pq.ParquetWriter(test_path, tbl.schema)
            twriter.write_table(tbl)
        if twriter is not None:
            twriter.close()
        out["test"] = test_path
    return out


class CovisJoiner:
    """Joins precomputed covis row features into the cache-build stream
    (reference build_cache_v2.py:209-228: train keyed by global row id
    ``rid``, test keyed by ``ID``; missing rows filled with 0.0)."""

    def __init__(self, covis_dir: str, is_train: bool):
        arrow()  # pandas reads Parquet through pyarrow: name it where it is missing
        import pandas as pd

        self.is_train = is_train
        path = os.path.join(
            covis_dir, "rowfeat_oof_all.parquet" if is_train else "rowfeat_test.parquet"
        )
        df = pd.read_parquet(path)
        key = "rid" if is_train else "ID"
        self.feature_names = [c for c in df.columns if c != key]
        self._df = df.set_index(key)

    def features_for(self, rid_base: int, n: int, ids: np.ndarray) -> np.ndarray:
        if self.is_train:
            keys = np.arange(rid_base, rid_base + n, dtype=np.int64)
        else:
            keys = np.asarray(ids).astype(str)
        sub = self._df.reindex(keys)
        return np.nan_to_num(sub.to_numpy(np.float64), nan=0.0).astype(np.float32)
