"""Stratified group K-fold split.

The JAX package's ``train_main`` takes ``StratifiedGroupKFold`` from
scikit-learn (``tossctr_tpu/train/trainer.py``); the port does not
depend on sklearn, so this module keeps a NumPy copy of what
scikit-learn 1.9.0 does (``sklearn/model_selection/_split.py``,
``StratifiedGroupKFold._iter_test_indices`` and ``_find_best_fold``),
giving the same folds index for index:

1. per-group class counts; with ``shuffle``, the group rows permuted by
   ``RandomState(random_state).shuffle``;
2. groups visited in a stable sort on minus the std of their class counts;
3. each group goes to the fold whose proposed class-share std, averaged
   over classes, is least; on a tie (``np.isclose``) the fold with fewer
   rows wins, and on a further tie the first fold.

sklearn counts classes and collects each fold's rows with per-row Python
loops; here both are vectorised.  The per-group assignment is sequential
by nature: it evaluates all folds of one group at once.
"""

from __future__ import annotations

import numbers
import warnings
from typing import Iterator, Tuple

import numpy as np


def _isclose(a: float, b: float) -> bool:
    """``np.isclose(a, b)`` for two floats (rtol 1e-5, atol 1e-8)."""
    if np.isinf(a) or np.isinf(b):
        return a == b
    return abs(a - b) <= 1e-8 + 1e-5 * abs(b)


class StratifiedGroupKFold:
    """``random_state``: the int seed of the group shuffle."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False, random_state=None):
        if not isinstance(n_splits, numbers.Integral) or n_splits <= 1:
            raise ValueError(f"n_splits must be an integer > 1, got {n_splits!r}")
        if not shuffle and random_state is not None:
            raise ValueError("random_state has no effect without shuffle; set shuffle=True")
        self.n_splits = int(n_splits)
        self.shuffle = bool(shuffle)
        self.random_state = random_state

    def _fold_of_groups(self, y, groups) -> Tuple[np.ndarray, np.ndarray]:
        """-> (fold of each group in the shuffled group order, each row's
        index into that order)."""
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
        if np.all(self.n_splits > y_cnt):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater than the number of "
                             "members in each class.")
        if self.n_splits > np.min(y_cnt):
            warnings.warn(f"The least populated class in y has only {np.min(y_cnt)} members, "
                          f"which is less than n_splits={self.n_splits}.", UserWarning)
        n_classes = len(y_cnt)
        _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True, return_counts=True)
        n_groups = len(groups_cnt)
        if self.n_splits > n_groups:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} greater "
                             f"than the number of groups: {n_groups}.")
        y_counts_per_group = np.bincount(
            groups_inv.ravel() * n_classes + y_inv.ravel(), minlength=n_groups * n_classes
        ).reshape(n_groups, n_classes).astype(np.float64)
        if self.shuffle:
            perm = np.arange(n_groups)
            np.random.RandomState(self.random_state).shuffle(perm)
            y_counts_per_group = y_counts_per_group[perm]
            inv_perm = np.empty_like(perm)
            inv_perm[perm] = np.arange(perm.size)
            groups_inv = inv_perm[groups_inv]
        # stable: groups with the same std keep the shuffled order
        order = np.argsort(-np.std(y_counts_per_group, axis=1), kind="stable")

        k = self.n_splits
        y_counts_per_fold = np.zeros((k, n_classes))
        y_cnt_row = y_cnt.reshape(1, 1, -1)
        add = np.eye(k)[:, :, None]  # candidate i adds the group to fold i
        fold_of = np.empty(n_groups, np.int64)
        for g in order:
            group_y_counts = y_counts_per_group[g]
            # every candidate fold at once: candidate i's (folds, classes)
            # counts, each fold's class share std, its mean over classes
            proposed = y_counts_per_fold[None] + add * group_y_counts
            evals = np.mean(np.std(proposed / y_cnt_row, axis=1), axis=1).tolist()
            samples = np.sum(y_counts_per_fold, axis=1).tolist()
            best, min_eval, min_samples = None, np.inf, np.inf
            for i in range(k):
                if evals[i] < min_eval or (_isclose(evals[i], min_eval)
                                           and samples[i] < min_samples):
                    best, min_eval, min_samples = i, evals[i], samples[i]
            y_counts_per_fold[best] += group_y_counts
            fold_of[g] = best
        return fold_of, groups_inv

    def split(self, X, y, groups) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (train indices, test indices) per fold, each sorted."""
        fold_of, groups_inv = self._fold_of_groups(y, groups)
        row_fold = fold_of[groups_inv]
        for i in range(self.n_splits):
            test = row_fold == i
            yield np.flatnonzero(~test), np.flatnonzero(test)
