"""Logging and seeding (port of ``tossctr_tpu/utils``)."""

from .log import Logger
from .seed import set_seed

__all__ = ["Logger", "set_seed"]
