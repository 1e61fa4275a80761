"""Seeding (port of ``tossctr_tpu/utils/seed.py``).

Seeds the host generators (numpy drives the samplers and the CV
shuffle) and torch's; ``deterministic`` turns off cuDNN's autotuner and
nondeterministic algorithms.  The train step's dropout draws from
generators seeded per step (``train/trainer.py``), not from these.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int, deterministic: bool = True) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
