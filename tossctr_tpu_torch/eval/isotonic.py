"""Isotonic regression in NumPy.

A copy of what scikit-learn 1.9.0's
``IsotonicRegression(y_min=0, y_max=1, out_of_bounds="clip")`` does in
``fit`` and ``predict`` (increasing; the one form the calibrators use),
so that the port calibrates without sklearn:

  1. drop rows of weight 0, sort by (x, y);
  2. merge equal x (sklearn's ``_make_unique``: an x within
     ``finfo.resolution`` of its run's first x joins the run) into the
     weighted mean of y and the summed weight;
  3. pool adjacent violators (scipy's ``isotonic_regression``, Busing's
     O(n) PAVA with the ``>=`` merges, so equal neighbours share a block);
  4. clip to [y_min, y_max];
  5. keep the thresholds as sklearn trims them: the ends, and every point
     whose value differs from a neighbour's;
  6. predict by the linear interpolation of scipy's ``interp1d`` between
     the thresholds, after clipping x to the fitted range.

``__setstate__`` takes the dict sklearn's ``__getstate__`` writes
(``X_thresholds_``, ``y_thresholds_``, ``X_min_``, ``X_max_``, the
constructor's arguments and ``_sklearn_version``; no ``f_``), so a
pickled sklearn object loads onto this class (``train/checkpoint.py``);
one of another form (decreasing, unbounded, ``out_of_bounds`` other than
"clip") is refused.
"""

from __future__ import annotations

import numpy as np


def _make_unique(X: np.ndarray, y: np.ndarray, w: np.ndarray):
    """(X sorted) -> (unique x, weighted mean y, summed weight)."""
    eps = np.finfo(X.dtype).resolution
    n = X.shape[0]
    # a step of eps or more from the previous x always starts a new value
    starts = np.r_[0, np.flatnonzero(np.diff(X) >= eps) + 1]
    # within a run of smaller steps the run's first x may still fall eps
    # behind: walk those runs as sklearn's loop does
    ends = np.r_[starts[1:], n]
    extra = []
    for r in np.flatnonzero(X[ends - 1] - X[starts] >= eps):
        cur = X[starts[r]]
        for j in range(starts[r] + 1, ends[r]):
            if X[j] - cur >= eps:
                extra.append(j)
                cur = X[j]
    if extra:
        starts = np.sort(np.r_[starts, extra])
    w_sum = np.add.reduceat(w, starts)
    return X[starts], np.add.reduceat(y * w, starts) / w_sum, w_sum


def _pava(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Increasing isotonic fit of ``x`` with weights ``w`` (Busing 2022,
    Algorithm 1, as scipy.optimize.isotonic_regression runs it)."""
    x = np.array(x, dtype=np.float64)
    w = np.array(w, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        return x
    r = np.empty(n + 1, dtype=np.int64)
    r[0], r[1] = 0, 1
    b = 0
    xb_prev, wb_prev = x[0], w[0]
    i = 1
    while i < n:
        b += 1
        xb, wb = x[i], w[i]
        if xb_prev >= xb:
            b -= 1
            sb = wb_prev * xb_prev + wb * xb
            wb += wb_prev
            xb = sb / wb
            while i < n - 1 and xb >= x[i + 1]:
                i += 1
                sb += w[i] * x[i]
                wb += w[i]
                xb = sb / wb
            while b > 0 and x[b - 1] >= xb:
                b -= 1
                sb += w[b] * x[b]
                wb += w[b]
                xb = sb / wb
        x[b] = xb_prev = xb
        w[b] = wb_prev = wb
        r[b + 1] = i + 1
        i += 1
    return np.repeat(x[:b + 1], np.diff(r[:b + 2]))


class IsotonicRegression:
    """sklearn's ``IsotonicRegression`` for ``increasing=True``,
    ``out_of_bounds="clip"`` and finite bounds; see the module
    docstring."""

    def __init__(self, *, y_min: float = 0.0, y_max: float = 1.0):
        self.y_min = y_min
        self.y_max = y_max
        self.increasing = True
        self.out_of_bounds = "clip"

    def _check(self):
        if (self.increasing is not True or self.out_of_bounds != "clip"
                or self.y_min is None or self.y_max is None):
            raise NotImplementedError(
                "only increasing, clipped isotonic regression with both bounds is ported: got "
                f"increasing={self.increasing!r}, out_of_bounds={self.out_of_bounds!r}, "
                f"y_min={self.y_min!r}, y_max={self.y_max!r}")

    def fit(self, X, y, sample_weight=None) -> "IsotonicRegression":
        self._check()
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=X.dtype).reshape(-1)
        w = (np.ones_like(X) if sample_weight is None
             else np.asarray(sample_weight, dtype=X.dtype).reshape(-1))
        keep = w > 0
        X, y, w = X[keep], y[keep], w[keep]
        order = np.lexsort((y, X))
        X, y, w = X[order], y[order], w[order]
        X, y, w = _make_unique(X, y, w)
        y = np.clip(_pava(y, w), self.y_min, self.y_max)
        self.X_min_, self.X_max_ = np.min(X), np.max(X)
        keep = np.ones(len(y), dtype=bool)
        keep[1:-1] = np.logical_or(np.not_equal(y[1:-1], y[:-2]), np.not_equal(y[1:-1], y[2:]))
        self.X_thresholds_, self.y_thresholds_ = X[keep], y[keep]
        return self

    def predict(self, T) -> np.ndarray:
        X, Y = self.X_thresholds_, self.y_thresholds_
        T = np.clip(np.asarray(T, dtype=X.dtype).reshape(-1), self.X_min_, self.X_max_)
        if len(Y) == 1:
            return np.repeat(Y, T.shape[0]).astype(T.dtype)
        hi = np.clip(np.searchsorted(X, T), 1, len(X) - 1)
        lo = hi - 1
        slope = (Y[hi] - Y[lo]) / (X[hi] - X[lo])
        return (slope * (T - X[lo]) + Y[lo]).astype(T.dtype)

    def __setstate__(self, state: dict) -> None:
        state = dict(state)
        state.pop("_sklearn_version", None)
        state.pop("f_", None)
        self.__dict__.update(state)
        self._check()
