"""Fold checkpoints and the in-fold train state.

Port of ``tossctr_tpu/train/checkpoint.py``.  Fold checkpoints are read
in two formats:

    runs/<exp>/ckpt_folds_<f>/      the port's own (save_fold_checkpoint)
      meta.json          score, best_score, epoch, global_step, cfg;
                         written last (finalize_fold_checkpoint): its
                         presence marks a complete checkpoint
      params.pt          torch.save'd state_dict of the live weights
      ema.pt             the EMA weights of the parameters the EMA tracks
                         (optional); with params.pt's other tensors they
                         are the merged EMA weights validation scored,
                         which serving takes over params.pt
      calibrator.json    Calibrator.to_json() (optional)

    runs/<exp>/ckpt_folds_<f>/      the JAX package's legacy form
      meta.json
      params.msgpack     flax-serialized variables ({"params": ...})
      ema.msgpack        EMA weights (optional)
      calibrator.pkl     pickled tossctr_tpu Calibrator (optional)

The msgpack files are read by ``flax_msgpack`` and converted by
``convert.flax_to_state_dict``; the pickle is read by an unpickler that
maps the JAX package's calibrator classes onto this package's, so
neither flax nor ``tossctr_tpu`` is imported.  The row-sharded
``params/`` directory form waits for the multi-device slice.

``save_train_state`` / ``load_train_state``: the step-resume state of
one fold (``runs/<exp>/fold_<f>_state.pt``) in the port's own
``torch.save`` form: the model (table included), AdamW, the table's
AdaGrad accumulator, the EMA, the global step and the loop's epoch,
wait, step in epoch and best so far.
"""

from __future__ import annotations

import glob
import io
import json
import os
import pickle
from typing import Any, Dict, Optional

import torch

from ..convert import flax_to_state_dict
from ..eval.calibration import Calibrator, TemperatureScaler
from . import flax_msgpack


def fold_ckpt_dir(exp_dir: str, fold: int) -> str:
    return os.path.join(exp_dir, f"ckpt_folds_{fold}")


def list_fold_checkpoints(exp_dir: str):
    """Sorted complete fold-checkpoint dirs (meta.json marks completion)."""
    dirs = sorted(glob.glob(os.path.join(exp_dir, "ckpt_folds_*")))
    return [d for d in dirs if os.path.exists(os.path.join(d, "meta.json"))]


def fold_ckpt_exists(exp_dir: str, fold: int) -> bool:
    """Fold-skip resume keys on a complete checkpoint."""
    return os.path.exists(os.path.join(fold_ckpt_dir(exp_dir, fold), "meta.json"))


def _save(obj, path: str) -> None:
    """torch.save through a temporary file, so a crash leaves the old file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save_fold_checkpoint(exp_dir: str, fold: int, *, state_dict: Dict[str, torch.Tensor],
                         cfg_dict: Dict, best_score: float, epoch: int, global_step: int,
                         ema: Optional[Dict[str, torch.Tensor]] = None,
                         calibrator: Optional[Calibrator] = None, complete: bool = True) -> str:
    """Write a fold checkpoint in the port's format: the weights, the EMA
    weights of the tracked parameters (``ema``), the calibrator, and,
    unless ``complete=False`` (the best-so-far save inside a fold),
    meta.json last."""
    d = fold_ckpt_dir(exp_dir, fold)
    os.makedirs(d, exist_ok=True)
    _save(_host(state_dict), os.path.join(d, "params.pt"))
    ema_path = os.path.join(d, "ema.pt")
    if ema is not None:
        _save(_host(ema), ema_path)
    elif os.path.exists(ema_path):
        os.remove(ema_path)
    if calibrator is not None:
        with open(os.path.join(d, "calibrator.json"), "w") as f:
            json.dump(calibrator.to_json(), f)
    if complete:
        finalize_fold_checkpoint(exp_dir, fold, cfg_dict=cfg_dict, best_score=best_score,
                                 epoch=epoch, global_step=global_step)
    return d


def finalize_fold_checkpoint(exp_dir: str, fold: int, *, cfg_dict: Dict, best_score: float,
                             epoch: int, global_step: int) -> None:
    """Stamp meta.json: the checkpoint is complete."""
    meta = {"fold": fold, "score": float(best_score), "best_score": float(best_score),
            "epoch": int(epoch), "global_step": int(global_step), "cfg": cfg_dict}
    with open(os.path.join(fold_ckpt_dir(exp_dir, fold), "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def save_train_state(path: str, state, **loop) -> None:
    """The step-resume state: ``state`` (a ``trainer.TrainState``) and the
    loop's counters (epoch, wait, step_in_epoch, best_score, best_epoch,
    best_global_step)."""
    payload = {
        "model": _host(state.model.state_dict()),
        "opt": state.opt.state_dict(),
        "table_opt": {n: t.accum.detach().cpu() for n, t in state.table_opt.items()},
        "ema": (None if state.ema is None else
                {"shadow": _host(state.ema.shadow), "num_updates": state.ema.num_updates}),
        "step": int(state.step),
        "loop": dict(loop),
    }
    _save(payload, path)


def load_train_state(path: str, state) -> Dict[str, Any]:
    """Restore ``state`` in place from ``save_train_state``'s file; -> the
    loop's counters."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.opt.load_state_dict(payload["opt"])
    for n, t in state.table_opt.items():
        t.accum.copy_(payload["table_opt"][n])
    if state.ema is not None:
        for n, s in state.ema.shadow.items():
            s.copy_(payload["ema"]["shadow"][n])
        state.ema.num_updates = int(payload["ema"]["num_updates"])
    state.step = int(payload["step"])
    return payload["loop"]


class _CalibratorUnpickler(pickle.Unpickler):
    """Resolves the JAX package's calibrator classes to this package's;
    refuses every other class."""

    _CLASSES = {
        ("tossctr_tpu.eval.calibration", "Calibrator"): Calibrator,
        ("tossctr_tpu.eval.calibration", "TemperatureScaler"): TemperatureScaler,
    }

    def find_class(self, module: str, name: str):
        cls = self._CLASSES.get((module, name))
        if cls is not None:
            return cls
        if module.startswith("sklearn"):
            raise NotImplementedError(
                f"calibrator.pkl holds {module}.{name}: isotonic calibration is not ported"
            )
        raise pickle.UnpicklingError(f"calibrator.pkl: class {module}.{name} is not allowed")


def load_legacy_calibrator(path: str) -> Calibrator:
    with open(path, "rb") as f:
        cal = _CalibratorUnpickler(io.BytesIO(f.read())).load()
    if not isinstance(cal, Calibrator):
        raise TypeError(f"{path} does not hold a Calibrator")
    if cal.iso is not None:
        raise NotImplementedError(f"{path}: isotonic calibration is not ported")
    return cal


def _load_legacy_weights(ckpt_dir: str, name: str) -> Optional[Dict[str, torch.Tensor]]:
    legacy = os.path.join(ckpt_dir, f"{name}.msgpack")
    if os.path.exists(legacy):
        return flax_to_state_dict(flax_msgpack.load(legacy))
    if os.path.isdir(os.path.join(ckpt_dir, name)):
        raise NotImplementedError(
            f"{ckpt_dir}/{name}/: row-sharded checkpoints are not ported"
        )
    return None


def load_fold_checkpoint(ckpt_dir: str) -> Dict[str, Any]:
    """-> meta.json's keys plus "params" (a state_dict), "ema" (the merged
    EMA weights, which override "params" for serving, or None) and
    "calibrator" (or None)."""
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        out: Dict[str, Any] = json.load(f)
    pt = os.path.join(ckpt_dir, "params.pt")
    if os.path.exists(pt):
        out["params"] = torch.load(pt, map_location="cpu", weights_only=True, mmap=True)
    else:
        out["params"] = _load_legacy_weights(ckpt_dir, "params")
    if out["params"] is None:
        raise FileNotFoundError(f"no params payload in {ckpt_dir}")
    ema_pt = os.path.join(ckpt_dir, "ema.pt")
    if os.path.exists(ema_pt):
        ema = torch.load(ema_pt, map_location="cpu", weights_only=True)
        out["ema"] = {k: ema.get(k, v) for k, v in out["params"].items()}
    else:
        out["ema"] = _load_legacy_weights(ckpt_dir, "ema")
    cal_json = os.path.join(ckpt_dir, "calibrator.json")
    cal_pkl = os.path.join(ckpt_dir, "calibrator.pkl")
    if os.path.exists(cal_json):
        with open(cal_json) as f:
            out["calibrator"] = Calibrator.from_json(json.load(f))
    elif os.path.exists(cal_pkl):
        out["calibrator"] = load_legacy_calibrator(cal_pkl)
    else:
        out["calibrator"] = None
    return out
