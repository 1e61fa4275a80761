"""Probability calibration by temperature scaling.

Port of ``tossctr_tpu/eval/calibration.py`` with the temperature method:
``fit_temperature`` (the same objective as the JAX package's: the
50:50-weighted NLL of sigmoid(z / T) plus ``l2_reg * (T - 1)^2``, over
log T by scipy's L-BFGS-B with the analytic gradient, log T bounded to
the clamp interval), ``TemperatureScaler``, ``Calibrator.fit`` and
``Calibrator.predict_proba``.  The attribute names are the JAX
package's, so a ``calibrator.pkl`` written there unpickles onto these
classes (``train/checkpoint.py``).  Isotonic calibration (sklearn)
waits for a later slice and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
    """method: 'temperature' (isotonic variants are not ported)."""

    def __init__(self, method: str = "temperature", lr: float = 0.05, iters: int = 200,
                 clamp_T=(0.2, 5.0), l2_reg: float = 1e-3, min_iso_nodes: int = 8):
        self.method = method
        self.lr = lr
        self.iters = iters
        self.clamp_T = tuple(clamp_T) if clamp_T is not None else None
        self.l2_reg = l2_reg
        self.min_iso_nodes = min_iso_nodes
        self.temp_scaler: Optional[TemperatureScaler] = None
        self.iso = None

    def _require_temperature(self):
        if self.method != "temperature" or self.iso is not None:
            raise NotImplementedError(
                f"calibration method {self.method!r}: only temperature scaling is ported"
            )

    def fit(self, logits, y) -> "Calibrator":
        self._require_temperature()
        self.temp_scaler = fit_temperature(
            np.asarray(logits, dtype=np.float64).ravel(), np.asarray(y, dtype=np.int32).ravel(),
            lr=self.lr, iters=self.iters, clamp_T=self.clamp_T, l2_reg=self.l2_reg)
        return self

    def predict_proba(self, logits) -> np.ndarray:
        self._require_temperature()
        z = np.asarray(logits, dtype=np.float64).ravel()
        if self.temp_scaler is not None:
            z = self.temp_scaler.transform(z)
        return np.clip(_sigmoid_stable(z), 1e-7, 1 - 1e-7)

    # the port's checkpoint form (calibrator.json)
    def to_json(self) -> dict:
        self._require_temperature()
        ts = self.temp_scaler
        return {
            "method": self.method, "lr": self.lr, "iters": self.iters,
            "clamp_T": list(self.clamp_T) if self.clamp_T is not None else None,
            "l2_reg": self.l2_reg, "min_iso_nodes": self.min_iso_nodes,
            "T": ts.T if ts is not None else None,
            "T_clamp": list(ts.clamp_T) if ts is not None and ts.clamp_T is not None else None,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Calibrator":
        cal = cls(d["method"], d["lr"], d["iters"], d["clamp_T"], d["l2_reg"],
                  d["min_iso_nodes"])
        if d.get("T") is not None:
            cal.temp_scaler = TemperatureScaler(d["T"], d.get("T_clamp"))
        cal._require_temperature()
        return cal
