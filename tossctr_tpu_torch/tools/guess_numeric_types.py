"""Schema inference: classify columns and suggest buckets/embedding dims
(port of ``tossctr_tpu/tools/guess_numeric_types.py``; needs pyarrow and
pandas, and PyYAML to write the suggestions):

    python -m tossctr_tpu_torch.tools.guess_numeric_types --parquet FILE
        [--out-dir outputs]

Per column: null count, n_unique, numeric min/max, int-like fraction ->
class ``continuous`` | ``int_like_categorical`` | ``empty``; vocab
suggestion n_unique + margin and an embedding dim via the sqrt/log rule.
Writes ``column_type_report.csv`` + ``column_suggestions.yaml``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.etl import arrow


def dim_rule(n_unique: int, lo: int = 8, hi: int = 64) -> int:
    """Embedding dim ~ 1.6 * n_unique**0.25, clipped (the standard
    heuristic the reference's dim table follows)."""
    d = int(round(1.6 * n_unique**0.25))
    return int(np.clip(d, lo, hi))


def analyze(parquet_path: str, skip_cols=("ID", "seq", "clicked"),
            int_like_max_unique: int = 50_000):
    import pandas as pd

    _, _, ds = arrow()
    d = ds.dataset(parquet_path, format="parquet")
    report = []
    for c in d.schema.names:
        if c in skip_cols:
            continue
        col = d.to_table(columns=[c])[c]
        vals = col.to_numpy(zero_copy_only=False)
        n = len(vals)
        if vals.dtype.kind == "f":
            nulls = int(np.isnan(vals).sum())
            finite = vals[~np.isnan(vals)]
        else:
            nulls = int(sum(v is None for v in vals.tolist())) if vals.dtype == object else 0
            finite = vals
        n_unique = int(pd.unique(finite).size)
        is_num = vals.dtype.kind in "fiu"
        vmin = float(np.min(finite)) if is_num and finite.size else None
        vmax = float(np.max(finite)) if is_num and finite.size else None
        if is_num and finite.size:
            f = np.asarray(finite, np.float64)
            int_frac = float(np.mean(f == np.round(f)))
        else:
            int_frac = 0.0
        if finite.size == 0:
            kind = "empty"
        elif is_num and int_frac > 0.999 and n_unique <= int_like_max_unique:
            kind = "int_like_categorical"
        elif is_num:
            kind = "continuous"
        else:
            kind = "string_categorical"
        report.append(
            dict(
                column=c, rows=n, nulls=nulls, n_unique=n_unique, min=vmin, max=vmax,
                int_like_frac=round(int_frac, 4), kind=kind,
            )
        )
    return report


def suggestions(report, margin_frac: float = 0.2):
    out = {"cat_cols": [], "hash_buckets": {}, "cat_embedding_dims": {}, "num_cols": []}
    for r in report:
        if r["kind"] in ("int_like_categorical", "string_categorical"):
            out["cat_cols"].append(r["column"])
            out["hash_buckets"][r["column"]] = int(r["n_unique"] * (1 + margin_frac)) + 3
            out["cat_embedding_dims"][r["column"]] = dim_rule(r["n_unique"])
        elif r["kind"] == "continuous":
            out["num_cols"].append(r["column"])
    return out


def main(argv=None):
    import pandas as pd
    import yaml

    ap = argparse.ArgumentParser()
    ap.add_argument("--parquet", required=True)
    ap.add_argument("--out-dir", default="outputs")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    rep = analyze(args.parquet)
    pd.DataFrame(rep).to_csv(os.path.join(args.out_dir, "column_type_report.csv"), index=False)
    sug = suggestions(rep)
    with open(os.path.join(args.out_dir, "column_suggestions.yaml"), "w") as f:
        yaml.safe_dump(sug, f, sort_keys=False)
    print(f"{len(rep)} columns -> {args.out_dir}/column_type_report.csv, column_suggestions.yaml")


if __name__ == "__main__":
    main()
