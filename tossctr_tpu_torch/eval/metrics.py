"""Competition metrics and fold ensembling.

Port of ``tossctr_tpu/eval/metrics.py``.  On the host, in NumPy:
``weighted_logloss_50_50``, ``ap_score`` (the JAX package calls
sklearn's ``average_precision_score``; ``average_precision`` here is the
same tie-aware step integral: one threshold per distinct score, ties
counted together), ``final_score``, ``ensemble_probs`` (every method)
and ``val_weighted_weights``.  On a device, in torch (the fold loop's
``eval.device_metrics: true``): ``average_precision_torch``,
``weighted_logloss_50_50_torch`` and ``final_score_device``, in fp32
like the JAX package's, with the host path's sanitation.
"""

from __future__ import annotations

import numpy as np


def weighted_logloss_50_50(y_true, y_prob, eps: float = 1e-12) -> float:
    """0.5 * mean NLL over positives + 0.5 * mean NLL over negatives; nan
    when a class is absent."""
    y_true = np.asarray(y_true).astype(np.float64, copy=False)
    y_prob = np.nan_to_num(np.asarray(y_prob), nan=0.5, posinf=1.0, neginf=0.0)
    y_prob = np.clip(y_prob.astype(np.float64, copy=False), eps, 1 - eps)
    pos = y_true == 1
    neg = ~pos
    if pos.sum() == 0 or neg.sum() == 0:
        return float("nan")
    pos_loss = -np.log(y_prob[pos]).mean()
    neg_loss = -np.log(1.0 - y_prob[neg]).mean()
    return float(0.5 * (pos_loss + neg_loss))


def average_precision(y_true, y_score) -> float:
    """sklearn's ``average_precision_score`` for binary labels (1 is the
    positive class), without sample weights: scores sorted descending,
    one threshold per distinct score (tied rows count together), precision
    and recall at each threshold, and AP = sum over thresholds of the
    recall step times the precision (sklearn.metrics._ranking:
    ``confusion_matrix_at_thresholds``, ``precision_recall_curve``)."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.float64)
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    thresholds = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def ap_score(y_true, y_prob) -> float:
    """Average precision with the reference's degenerate-label guard (0.0
    when one class is absent) and its nan / clip handling."""
    y_true = np.asarray(y_true)
    if float(y_true.mean()) in (0.0, 1.0) or len(np.unique(y_true)) < 2:
        return 0.0
    y_prob = np.nan_to_num(np.asarray(y_prob), nan=0.5, posinf=1.0, neginf=0.0)
    y_prob = np.clip(y_prob, 1e-12, 1 - 1e-12)
    return average_precision(y_true, y_prob)


def final_score(y_true, y_prob, formula: str = "reference"):
    """-> (ap, wll, score).  ``formula='reference'``: score = 0.5*AP +
    0.5*WLL, the reference's literal composite; ``'competition'``:
    0.5*AP + 0.5/(1 + WLL)."""
    ap = ap_score(y_true, y_prob)
    wll = weighted_logloss_50_50(y_true, y_prob)
    if formula == "competition":
        score = 0.5 * ap + 0.5 / (1.0 + wll)
    else:
        score = 0.5 * ap + 0.5 * wll
    return ap, wll, score


def average_precision_torch(y_true, y_score, device=None):
    """Tie-aware average precision in fp32 on ``device`` (a 0-d tensor):
    sklearn's ``average_precision_score``, with precision and recall taken
    at the last element of each tie run in descending-score order.  One
    stable sort, cumulative sums and a running max (the recall at the
    previous kept threshold); 0 when no row is positive.  Scores are
    sanitised as on the host: NaN -> 0.5, +-inf clipped into [0, 1]."""
    import torch

    y = torch.as_tensor(y_true, dtype=torch.float32, device=device).ravel()
    s = torch.as_tensor(y_score, dtype=torch.float32, device=device)
    s = torch.nan_to_num(s, nan=0.5, posinf=1.0, neginf=0.0).clamp(0.0, 1.0).ravel()
    n = y.shape[0]
    order = torch.argsort(-s, stable=True)
    ys, ss = y[order], s[order]
    tp = torch.cumsum(ys, 0)
    total_pos = tp[-1]
    precision = tp / torch.arange(1, n + 1, dtype=torch.float32, device=y.device)
    recall = tp / torch.clamp(total_pos, min=1.0)
    # the last element of each tie run
    keep = torch.cat([ss[1:] != ss[:-1], torch.ones(1, dtype=torch.bool, device=y.device)])
    # recall is nondecreasing: the previous kept recall is the running max
    # of the kept recalls, shifted by one
    masked = torch.where(keep, recall, torch.zeros_like(recall))
    prev_kept = torch.cat([torch.zeros(1, device=y.device),
                           torch.cummax(masked, 0).values[:-1]])
    ap = torch.where(keep, (recall - prev_kept) * precision, torch.zeros_like(recall)).sum()
    return torch.where(total_pos > 0, ap, torch.zeros_like(ap))


def weighted_logloss_50_50_torch(y_true, y_prob, eps: float = 1e-12, device=None):
    """The 50:50 WLL in fp32 on ``device`` (a 0-d tensor).  The clip floor
    is max(eps, 1e-7): the host's 1e-12 does not exist next to 1.0 in
    fp32.  NaN -> 0.5, +-inf clipped, as on the host."""
    import torch

    y = torch.as_tensor(y_true, dtype=torch.float32, device=device).ravel()
    eps32 = max(float(eps), 1e-7)
    p = torch.as_tensor(y_prob, dtype=torch.float32, device=device)
    p = torch.nan_to_num(p, nan=0.5, posinf=1.0, neginf=0.0).clamp(eps32, 1.0 - eps32).ravel()
    pos = y == 1
    n_pos = torch.clamp(pos.sum(), min=1)
    n_neg = torch.clamp((~pos).sum(), min=1)
    zero = torch.zeros_like(p)
    pos_loss = torch.where(pos, -torch.log(p), zero).sum() / n_pos
    neg_loss = torch.where(~pos, -torch.log(1.0 - p), zero).sum() / n_neg
    return 0.5 * (pos_loss + neg_loss)


def final_score_device(y_true, y_prob, formula: str = "reference", device=None):
    """-> (ap, wll, score) as Python floats, the AP and WLL computed on
    ``device``; ``formula`` as in ``final_score``."""
    ap = float(average_precision_torch(y_true, y_prob, device=device))
    wll = float(weighted_logloss_50_50_torch(y_true, y_prob, device=device))
    if formula == "competition":
        return ap, wll, 0.5 * ap + 0.5 / (1.0 + wll)
    return ap, wll, 0.5 * ap + 0.5 * wll


def _safe_prob_to_logit(p: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    p = np.clip(p, eps, 1 - eps)
    return np.log(p) - np.log1p(-p)


def _rank_avg_stack(p_list) -> np.ndarray:
    ranks = []
    for p in p_list:
        order = np.argsort(p)
        r = np.empty_like(p)
        r[order] = np.arange(p.size, dtype=p.dtype)
        r = (r + 1.0) / (p.size + 1.0)
        ranks.append(r)
    return np.stack(ranks, 0).mean(0)


def ensemble_probs(method, p_list, z_list=None, weights=None, trim_ratio: float = 0.0):
    """method: mean | logit_mean | geom_mean | median | trim_mean | rank_avg | weighted."""
    p_list = [np.asarray(p, dtype=np.float64).ravel() for p in p_list]
    M = len(p_list)
    P = np.stack(p_list, 0)  # (M, B)
    w = None
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()

    if method == "mean":
        return P.mean(0) if w is None else (P * w[:, None]).sum(0)
    if method == "geom_mean":
        logP = np.log(np.clip(P, 1e-7, 1 - 1e-7))
        m = logP.mean(0) if w is None else (logP * w[:, None]).sum(0)
        return np.exp(m)
    if method == "logit_mean":
        L = _safe_prob_to_logit(P)
        Lm = L.mean(0) if w is None else (L * w[:, None]).sum(0)
        return 1.0 / (1.0 + np.exp(-Lm))
    if method == "median":
        return np.median(P, 0)
    if method == "trim_mean":
        k = int(max(0, min(M // 2, round(M * trim_ratio))))
        if k == 0:
            return P.mean(0)
        Ps = np.sort(P, axis=0)
        return Ps[k : M - k].mean(0)
    if method == "rank_avg":
        return _rank_avg_stack(p_list)
    if method == "weighted":
        assert w is not None, "weights required for method='weighted'"
        return (P * w[:, None]).sum(0)
    raise ValueError(f"Unknown ensemble method: {method}")


def val_weighted_weights(scores, temperature: float = 10.0) -> np.ndarray:
    """softmax(fold scores / T) weights for method='val_weighted'
    (reference: src/infer.py:135-149)."""
    s = np.asarray(scores, dtype=np.float64) / max(1e-6, float(temperature))
    s = s - s.max()
    e = np.exp(s)
    return e / e.sum()
