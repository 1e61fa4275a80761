"""Blend two submission CSVs (port of
``tossctr_tpu/tools/blend_submissions.py``; needs pandas):

    python -m tossctr_tpu_torch.tools.blend_submissions --a A.csv --b B.csv
        --out OUT.csv [--method mean|logit_mean|rank_mean] [--w 0.5]

Methods: mean | logit_mean | rank_mean with weight w on the first file;
inner-join on ID with row-count validation and correlation/mean
diagnostics.
"""

from __future__ import annotations

import argparse

import numpy as np


def blend(a: "pd.DataFrame", b: "pd.DataFrame", method: str = "logit_mean",
          w: float = 0.5) -> "pd.DataFrame":
    """The blend of submissions ``a`` and ``b`` (columns ID, clicked), ``w``
    on ``a``; raises ValueError unless both hold the same IDs."""
    import pandas as pd

    m = a.merge(b, on="ID", how="inner", suffixes=("_a", "_b"))
    if len(m) != len(a) or len(m) != len(b):
        raise ValueError(
            f"ID mismatch: {len(a)} vs {len(b)} rows, inner join {len(m)}"
        )
    pa_ = np.clip(m["clicked_a"].to_numpy(np.float64), 1e-7, 1 - 1e-7)
    pb_ = np.clip(m["clicked_b"].to_numpy(np.float64), 1e-7, 1 - 1e-7)
    if method == "mean":
        p = w * pa_ + (1 - w) * pb_
    elif method == "logit_mean":
        za = np.log(pa_) - np.log1p(-pa_)
        zb = np.log(pb_) - np.log1p(-pb_)
        p = 1 / (1 + np.exp(-(w * za + (1 - w) * zb)))
    elif method == "rank_mean":
        ra = pd.Series(pa_).rank(method="average").to_numpy() / (len(pa_) + 1)
        rb = pd.Series(pb_).rank(method="average").to_numpy() / (len(pb_) + 1)
        p = w * ra + (1 - w) * rb
    else:
        raise ValueError(f"unknown method {method}")
    corr = float(np.corrcoef(pa_, pb_)[0, 1])
    print(
        f"corr={corr:.4f} mean_a={pa_.mean():.6f} mean_b={pb_.mean():.6f} "
        f"mean_blend={p.mean():.6f}"
    )
    return pd.DataFrame({"ID": m["ID"], "clicked": p})


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", default="logit_mean", choices=["mean", "logit_mean", "rank_mean"])
    ap.add_argument("--w", type=float, default=0.5)
    args = ap.parse_args(argv)
    a = pd.read_csv(args.a, dtype={"ID": str})
    b = pd.read_csv(args.b, dtype={"ID": str})
    out = blend(a, b, method=args.method, w=args.w)
    out.to_csv(args.out, index=False, float_format="%.8f")
    print(f"wrote {args.out} ({len(out)} rows)")


if __name__ == "__main__":
    main()
