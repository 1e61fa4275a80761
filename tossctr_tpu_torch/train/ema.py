"""EMA shadow weights.

Port of ``tossctr_tpu/train/ema.py``: fp32 shadows keyed by parameter
name, with the decay warmup (linear / cosine / none),
``update_after_step`` / ``update_interval`` gating and the name filter.
Filtered parameters get no shadow at all: in sparse-table mode the
trainer filters the 10M-row sequence table, whose fp32 shadow would be
5 GB.  The update runs after the optimizer step, in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Sequence

import numpy as np
import torch


@dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]  # fp32 shadows of the tracked parameters
    num_updates: int = 0  # realised EMA updates


def make_ema_mask(names: Iterable[str], param_filter: Sequence[str]) -> Dict[str, bool]:
    """{name: tracked} -- a parameter is tracked unless a filter string
    is a substring of its flax path (``params/`` + the name with ``/``
    for ``.``, as ``convert.py`` maps them)."""
    return {n: not any(f in "params/" + n.replace(".", "/") for f in param_filter)
            for n in names}


def init_ema(params: Dict[str, torch.Tensor], mask: Dict[str, bool]) -> EmaState:
    """A fp32 copy of every tracked parameter."""
    return EmaState({n: p.detach().float().clone() for n, p in params.items() if mask[n]})


def decay_at(num_updates: int, base_decay: float, warmup_steps: int, warmup_type: str) -> float:
    """The effective decay, float32 arithmetic: (1 - decay) ramps up over
    the warmup."""
    f32 = np.float32
    d = f32(base_decay)
    if warmup_steps <= 0 or warmup_type == "none":
        return float(d)
    t = min(f32(1.0), (f32(num_updates) + f32(1.0)) / f32(warmup_steps))
    if warmup_type == "cosine":
        c = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * (f32(1.0) - t)))
        dec = f32(1.0) - (f32(1.0) - d) * c
    else:  # linear
        dec = f32(1.0) - (f32(1.0) - d) * t
    return float(np.clip(dec, f32(0.0), f32(1.0)))


@torch.no_grad()
def update_ema(ema: EmaState, params: Dict[str, torch.Tensor], global_step: int, *,
               base_decay: float, warmup_steps: int, warmup_type: str,
               update_after_step: int, update_interval: int) -> EmaState:
    """shadow = shadow * (1 - a) + param * a with a = 1 - decay, when the
    step passes the gate; called after the optimizer step with the new
    global step."""
    interval = max(1, int(update_interval))
    if global_step < update_after_step or (global_step - update_after_step) % interval:
        return ema
    a = np.float32(1.0) - np.float32(decay_at(ema.num_updates, base_decay, warmup_steps,
                                             warmup_type))
    keep = float(np.float32(1.0) - a)
    for n, s in ema.shadow.items():
        s.mul_(keep).add_(params[n].detach().float() * float(a))
    ema.num_updates += 1
    return ema


def ema_params(ema: EmaState, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The EMA weights in the parameters' dtypes; untracked parameters are
    the live ones."""
    return {n: ema.shadow[n].to(p.dtype) if n in ema.shadow else p for n, p in params.items()}
