"""Learning-rate schedule.

Port of ``tossctr_tpu/train/sched.py`` ``make_lr_schedule``: linear
warmup then cosine decay, a pure function of the global step.  optax
evaluates it at the optimizer's update count before the increment, so
the trainer calls it with the step the update starts from (0 on the
first step).  The value is computed in float32, as the JAX schedule is.
"""

from __future__ import annotations

import numpy as np


def make_lr_schedule(base_lr: float, warmup_steps: int, total_steps: int, cosine: bool = True):
    """-> schedule(step) -> learning rate as a Python float (a float32
    value)."""
    warmup_steps = max(1, int(warmup_steps))
    f32 = np.float32
    lr = f32(base_lr)

    def schedule(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(lr * (s + f32(1.0)) / f32(warmup_steps))
        if not cosine:
            return float(lr)
        progress = (s - f32(warmup_steps)) / f32(max(1, total_steps - warmup_steps))
        return float(f32(0.5) * lr * (f32(1.0) + np.cos(f32(np.pi) * progress)))

    return schedule
