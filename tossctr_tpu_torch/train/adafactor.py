"""Adafactor, as ``optax.adafactor`` defines it, and plain SGD: the
dense-mode table optimizers (``train.embedding_optimizer: adafactor |
sgd``).

The port's own copy of optax 0.2.6's ``adafactor`` (``optax/_src/alias.py``
with ``optax/_src/factorized.py``) at its defaults, the only settings the
JAX trainer uses (``optax.adafactor(schedule)``): the factored second
moment (``scale_by_factored_rms``: ``min_dim_size_to_factor=128``,
``decay_rate=0.8``, ``decay_offset=0``, ``epsilon=1e-30``), the
block-RMS clip at 1.0, the learning rate, the parameter's block RMS
(``multiply_by_parameter_scale``, at least 1e-3), no momentum, no weight
decay, then the step down.  A tensor is factored over its two largest
dimensions when the second largest is at least 128 (``factored_dims``):
a split (V, 64) sequence table is not, a lane-fused (V, 128) one is.
``torch.optim.Adafactor`` is another algorithm (its own decay, no
block-RMS clip or parameter scale) and is not used.

The state is kept as optax keeps it, in each parameter's dtype: per
parameter ``v_row`` and ``v_col`` (factored; else (1,) placeholders) or
``v`` (not factored; else a (1,) placeholder), and one update ``count``.
The decay blends run in fp32 (JAX promotes them: the decay rate is an
fp32 array) and are stored in the parameter's dtype.

``SGD``: ``optax.sgd(schedule)`` without momentum, p - lr * g.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Adafactor", "SGD", "factored_dims"]

# optax.adafactor's defaults, the JAX trainer's settings
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8  # the second moment's decay: 1 - (count + 1)^-0.8
CLIPPING_THRESHOLD = 1.0  # clip_by_block_rms
MIN_PARAM_RMS = 1e-3  # scale_by_param_block_rms
EPS = 1e-30  # added to g^2


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) dimension
    to reduce over, or None when the tensor is not factored (not 2-D or
    more, or its second largest dimension below MIN_DIM_SIZE_TO_FACTOR)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def decay_rate_at(count: int) -> float:
    """1 - (count + 1)^-DECAY_RATE in float32 (optax's ``_decay_rate_pow``)."""
    t = np.float32(count + 1)
    return float(np.float32(1.0) - t ** np.float32(-DECAY_RATE))


class Adafactor:
    """``optax.adafactor`` over ``params`` ({name: parameter}); ``step``
    takes each parameter's gradient from its ``.grad`` and the step's
    learning rate (the schedule at the update count)."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = dict(params)
        self.count = 0
        self.v_row, self.v_col, self.v = {}, {}, {}
        for n, p in self.params.items():
            dims = factored_dims(tuple(p.shape))
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is not None:
                d1, d0 = dims
                self.v_row[n] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype,
                                            device=p.device)
                self.v_col[n] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype,
                                            device=p.device)
                self.v[n] = one
            else:
                self.v_row[n], self.v_col[n], self.v[n] = one, one.clone(), torch.zeros_like(p)

    def _scaled(self, n: str, p: torch.Tensor, g: torch.Tensor, d: float) -> torch.Tensor:
        """The factored-RMS scaled gradient of one parameter; updates its
        second-moment state."""
        dt = p.dtype
        g_sq = g * g + EPS
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            self.v[n] = (d * self.v[n].float() + (1.0 - d) * g_sq.float()).to(dt)
            return g * self.v[n] ** -0.5
        d1, d0 = dims
        self.v_row[n] = (d * self.v_row[n].float()
                         + (1.0 - d) * g_sq.mean(dim=d0).float()).to(dt)
        self.v_col[n] = (d * self.v_col[n].float()
                         + (1.0 - d) * g_sq.mean(dim=d1).float()).to(dt)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = self.v_row[n].mean(dim=reduced_d1, keepdim=True)
        row_factor = (self.v_row[n] / row_col_mean) ** -0.5
        col_factor = self.v_col[n] ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    @torch.no_grad()
    def step(self, lr: float) -> None:
        d = decay_rate_at(self.count)
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            u = self._scaled(n, p, g, d)
            # clip_by_block_rms
            denom = torch.clamp(torch.sqrt((u * u).mean()) / CLIPPING_THRESHOLD, min=1.0)
            u = u / denom.to(u.dtype)
            u = u * torch.tensor(lr, dtype=u.dtype, device=u.device)
            # scale_by_param_block_rms
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms <= MIN_PARAM_RMS, torch.full_like(rms, MIN_PARAM_RMS), rms)
            p.add_(u * -1)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "v_row": dict(self.v_row), "v_col": dict(self.v_col),
                "v": dict(self.v)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for key in ("v_row", "v_col", "v"):
            mine = getattr(self, key)
            for n, t in sd[key].items():
                mine[n] = t.to(mine[n].device, mine[n].dtype).reshape(mine[n].shape).clone()


class SGD:
    """``optax.sgd(schedule)``: p - lr * g, the step in the gradient's
    dtype."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = dict(params)

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for p in self.params.values():
            if p.grad is not None:
                p.add_(p.grad * torch.tensor(-lr, dtype=p.grad.dtype, device=p.device))

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, sd: dict) -> None:
        pass
