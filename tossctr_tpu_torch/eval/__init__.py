"""Calibration (temperature and isotonic), the metrics on the host or a
device, and fold ensembling (port of ``tossctr_tpu/eval``)."""

from .calibration import Calibrator, TemperatureScaler
from .metrics import ensemble_probs, val_weighted_weights

__all__ = ["Calibrator", "TemperatureScaler", "ensemble_probs", "val_weighted_weights"]
