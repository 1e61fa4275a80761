"""Hash-bucket collision audit (port of
``tossctr_tpu/tools/check_hash_collisions.py``; needs pyarrow):

    python -m tossctr_tpu_torch.tools.check_hash_collisions --parquet FILE
        [--column inventory_id] [--candidates M ...] [--target 0.01]

For candidate bucket sizes m, computes the realized collision ratio
``1 - unique_buckets / n_unique`` under the cache's own stable hash, and
recommends the smallest m hitting a target collision rate via the
balls-in-bins estimate ``E[unique] = m * (1 - (1 - 1/m)^n)`` bisected
over m.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np

from ..data.etl import arrow
from ..utils.hashing import stable_hash64


def unique_buckets_for_m(hashes: np.ndarray, m: int) -> int:
    return int(np.unique(hashes % np.uint64(m)).size)


def collision_ratio(hashes: np.ndarray, m: int, n_unique: int) -> float:
    return 1.0 - unique_buckets_for_m(hashes, m) / max(1, n_unique)


def expected_collision_ratio(n: int, m: int) -> float:
    return 1.0 - m * (1.0 - (1.0 - 1.0 / m) ** n) / n


def recommend_m(n_unique: int, target_ratio: float, lo: int = 11, hi: int = 1 << 28) -> int:
    """Smallest m with expected collision ratio <= target (bisection)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if expected_collision_ratio(n_unique, mid) <= target_ratio:
            hi = mid
        else:
            lo = mid + 1
    return lo


def audit_column(parquet_path: str, column: str, candidates: List[int], target: float,
                 seed: int = 2025):
    _, _, ds = arrow()
    d = ds.dataset(parquet_path, format="parquet")
    vals = d.to_table(columns=[column])[column].to_numpy(zero_copy_only=False)
    uniq_vals = np.unique(vals[vals == vals] if vals.dtype.kind == "f" else vals)
    h = stable_hash64(uniq_vals, seed=seed)
    n_unique = uniq_vals.size
    print(f"column={column} n_unique={n_unique}")
    rows = []
    for m in candidates:
        r = collision_ratio(h, m, n_unique)
        e = expected_collision_ratio(n_unique, m)
        rows.append((m, r, e))
        print(f"  m={m:>10d}  collision={r:8.5f}  expected={e:8.5f}")
    rec = recommend_m(n_unique, target)
    print(f"  recommended m for target {target}: {rec}")
    return {"n_unique": n_unique, "rows": rows, "recommended": rec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parquet", required=True)
    ap.add_argument("--column", default="inventory_id")
    ap.add_argument("--candidates", type=int, nargs="*", default=[1009, 10007, 100003, 1000003])
    ap.add_argument("--target", type=float, default=0.01)
    args = ap.parse_args(argv)
    audit_column(args.parquet, args.column, args.candidates, args.target)


if __name__ == "__main__":
    main()
