"""Console / CSV / TensorBoard logging.

Port of ``tossctr_tpu/utils/log.py`` ``Logger``: a console line per row
(through ``rich`` where it is installed), an append-only
``train_log.csv`` with the columns
``time,fold,epoch,split,loss,AP,WLL,Score,lr,bs,K,tau``, per-fold
TensorBoard scalars when ``torch.utils.tensorboard`` imports (as in the
JAX package, a failed import means no writer), and the per-epoch
examples/s counter.
"""

from __future__ import annotations

import csv
import os
import time

_CSV_COLS = ["fold", "epoch", "split", "loss", "AP", "WLL", "Score", "lr", "bs", "K", "tau"]


class Logger:
    def __init__(self, log_dir: str, tb: bool = True, csv_log: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.tb = None
        if tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except Exception:
                self.tb = None
        self.csv_path = os.path.join(log_dir, "train_log.csv") if csv_log else None
        if self.csv_path and not os.path.exists(self.csv_path):
            with open(self.csv_path, "w", newline="") as f:
                csv.writer(f).writerow(["time"] + _CSV_COLS)
        try:
            from rich.console import Console

            self._console = Console()
        except Exception:
            self._console = None

    def scalars(self, tag: str, step: int, **kwargs) -> None:
        if self.tb:
            for k, v in kwargs.items():
                self.tb.add_scalar(f"{tag}/{k}", v, step)

    def row(self, **kwargs) -> None:
        msg = "  ".join(f"{k}={v}" for k, v in kwargs.items())
        if self._console is not None:
            self._console.print(msg)
        else:
            print(msg, flush=True)

    def csv(self, **kwargs) -> None:
        if self.csv_path:
            with open(self.csv_path, "a", newline="") as f:
                row = [time.strftime("%Y-%m-%d %H:%M:%S")]
                row += [kwargs.get(k, "") for k in _CSV_COLS]
                csv.writer(f).writerow(row)

    def throughput(self, tag: str, step: int, examples: int, seconds: float) -> None:
        self.scalars(tag, step, examples_per_sec=examples / max(seconds, 1e-9))
