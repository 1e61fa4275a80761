"""Probability calibration: temperature scaling and isotonic regression.

Port of ``tossctr_tpu/eval/calibration.py``: ``fit_temperature`` (the
same objective as the JAX package's: the 50:50-weighted NLL of
sigmoid(z / T) plus ``l2_reg * (T - 1)^2``, over log T by scipy's
L-BFGS-B with the analytic gradient, log T bounded to the clamp
interval), ``TemperatureScaler`` and ``Calibrator`` with the methods
``temperature``, ``isotonic`` and ``temperature+isotonic``.  The
isotonic map is fitted on sigmoid(z / T) with the 50:50 class weights by
the port's NumPy copy of sklearn's ``IsotonicRegression``
(``eval/isotonic.py``); below ``min_iso_nodes`` distinct probabilities it
is skipped.  The attribute names are the JAX package's, so a
``calibrator.pkl`` written there, sklearn's isotonic object included,
unpickles onto these classes (``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .isotonic import IsotonicRegression

METHODS = ("temperature", "isotonic", "temperature+isotonic")

def _sigmoid_stable(z: np.ndarray) -> np.ndarray:
    z = np.clip(z, -50.0, 50.0)
    return 1.0 / (1.0 + np.exp(-z))


class TemperatureScaler:
    """Holds a fitted temperature; ``transform`` maps logits -> logits/T."""

    def __init__(self, T: float = 1.0, clamp_T=(0.2, 5.0)):
        self.T = float(T)
        self.clamp_T = tuple(clamp_T) if clamp_T is not None else None

    @property
    def T_eff(self) -> float:
        if self.clamp_T is None:
            return self.T
        return float(np.clip(self.T, self.clamp_T[0], self.clamp_T[1]))

    def transform(self, logits: np.ndarray) -> np.ndarray:
        return np.asarray(logits, dtype=np.float64) / self.T_eff


def fit_temperature(logits, y, lr: float = 0.05, iters: int = 200, clamp_T=(0.2, 5.0),
                    l2_reg: float = 1e-3) -> TemperatureScaler:
    """The temperature minimising the 50:50-weighted NLL of sigmoid(z / T)
    plus ``l2_reg * (T - 1)^2``.  ``lr`` is kept for config parity:
    L-BFGS-B needs none."""
    from scipy.optimize import minimize

    z = np.asarray(logits, dtype=np.float64).ravel()
    t = np.asarray(y, dtype=np.float64).ravel()
    n_pos = max(1, int(t.sum()))
    n_neg = max(1, int((t == 0).sum()))
    lo, hi = clamp_T if clamp_T is not None else (1e-3, 1e3)

    def objective(lt):
        T = float(np.exp(lt[0]))
        zt = z / T
        p = np.clip(_sigmoid_stable(zt), 1e-7, 1 - 1e-7)
        loss_pos = -np.sum(t * np.log(p)) / n_pos
        loss_neg = -np.sum((1 - t) * np.log(1 - p)) / n_neg
        loss = 0.5 * (loss_pos + loss_neg) + l2_reg * (T - 1.0) ** 2
        # d zt/d lt = -zt; d(-log p)/d zt = -(1 - p); d(-log(1 - p))/d zt = p
        g_pos = np.sum(t * (1 - p) * zt) / n_pos
        g_neg = -np.sum((1 - t) * p * zt) / n_neg
        grad = 0.5 * (g_pos + g_neg) + 2.0 * l2_reg * (T - 1.0) * T
        return loss, np.array([grad])

    res = minimize(objective, x0=np.array([0.0]), jac=True, method="L-BFGS-B",
                   bounds=[(np.log(lo), np.log(hi))], options={"maxiter": int(iters)})
    return TemperatureScaler(T=float(np.exp(res.x[0])), clamp_T=clamp_T)


class Calibrator:
    """method: 'temperature' | 'isotonic' | 'temperature+isotonic'."""

    def __init__(self, method: str = "temperature", lr: float = 0.05, iters: int = 200,
                 clamp_T=(0.2, 5.0), l2_reg: float = 1e-3, min_iso_nodes: int = 8):
        if method not in METHODS:
            raise ValueError(f"calibration method must be one of {METHODS}, got {method!r}")
        self.method = method
        self.lr = lr
        self.iters = iters
        self.clamp_T = tuple(clamp_T) if clamp_T is not None else None
        self.l2_reg = l2_reg
        self.min_iso_nodes = min_iso_nodes
        self.temp_scaler: Optional[TemperatureScaler] = None
        self.iso: Optional[IsotonicRegression] = None

    def fit(self, logits, y) -> "Calibrator":
        z = np.asarray(logits, dtype=np.float64).ravel()
        y = np.asarray(y, dtype=np.int32).ravel()
        if self.method in ("temperature", "temperature+isotonic"):
            self.temp_scaler = fit_temperature(z, y, lr=self.lr, iters=self.iters,
                                               clamp_T=self.clamp_T, l2_reg=self.l2_reg)
        if self.method in ("isotonic", "temperature+isotonic"):
            zt = self.temp_scaler.transform(z) if self.temp_scaler is not None else z
            p = _sigmoid_stable(zt)
            n_pos = max(1, int(y.sum()))
            n_neg = max(1, int((y == 0).sum()))
            sw = np.where(y == 1, 0.5 / n_pos, 0.5 / n_neg)
            if np.unique(p).size < self.min_iso_nodes:
                self.iso = None
            else:
                self.iso = IsotonicRegression(y_min=0.0, y_max=1.0)
                self.iso.fit(p, y, sample_weight=sw)
        return self

    def predict_proba(self, logits) -> np.ndarray:
        z = np.asarray(logits, dtype=np.float64).ravel()
        if self.temp_scaler is not None:
            z = self.temp_scaler.transform(z)
        p = _sigmoid_stable(z)
        if self.iso is not None:
            p = self.iso.predict(np.clip(p, 1e-7, 1 - 1e-7))
        return np.clip(p, 1e-7, 1 - 1e-7)

    def meta(self) -> dict:
        """The summary ``tools/run_calibration.py`` writes as cal_meta.json."""
        out = {"method": self.method}
        if self.temp_scaler is not None:
            out["T"] = self.temp_scaler.T_eff
        if self.iso is not None:
            out["iso_thresholds_x"] = np.asarray(self.iso.X_thresholds_).tolist()
            out["iso_thresholds_y"] = np.asarray(self.iso.y_thresholds_).tolist()
        return out

    # the port's checkpoint form (calibrator.json); floats round-trip exactly
    def to_json(self) -> dict:
        ts, iso = self.temp_scaler, self.iso
        return {
            "method": self.method, "lr": self.lr, "iters": self.iters,
            "clamp_T": list(self.clamp_T) if self.clamp_T is not None else None,
            "l2_reg": self.l2_reg, "min_iso_nodes": self.min_iso_nodes,
            "T": ts.T if ts is not None else None,
            "T_clamp": list(ts.clamp_T) if ts is not None and ts.clamp_T is not None else None,
            "iso": None if iso is None else {
                "y_min": iso.y_min, "y_max": iso.y_max,
                "X_min": float(iso.X_min_), "X_max": float(iso.X_max_),
                "X_thresholds": np.asarray(iso.X_thresholds_).tolist(),
                "y_thresholds": np.asarray(iso.y_thresholds_).tolist(),
            },
        }

    @classmethod
    def from_json(cls, d: dict) -> "Calibrator":
        cal = cls(d["method"], d["lr"], d["iters"], d["clamp_T"], d["l2_reg"],
                  d["min_iso_nodes"])
        if d.get("T") is not None:
            cal.temp_scaler = TemperatureScaler(d["T"], d.get("T_clamp"))
        iso = d.get("iso")
        if iso is not None:
            cal.iso = IsotonicRegression(y_min=iso["y_min"], y_max=iso["y_max"])
            cal.iso.X_min_, cal.iso.X_max_ = np.float64(iso["X_min"]), np.float64(iso["X_max"])
            cal.iso.X_thresholds_ = np.asarray(iso["X_thresholds"], dtype=np.float64)
            cal.iso.y_thresholds_ = np.asarray(iso["y_thresholds"], dtype=np.float64)
        return cal
