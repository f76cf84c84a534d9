"""Scalar and image logging (port of nerf_simple_tpu/utils/tb.py).

Scalars always go to ``<log_dir>/scalars.csv``; scalars and images also
go to TensorBoard when ``torch.utils.tensorboard`` imports (the card's
machine has no tensorboard package, so there the CSV is the record).
"""

from __future__ import annotations

import csv
import os
import time


class Logger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir)
        self._csv = open(os.path.join(log_dir, "scalars.csv"), "a", newline="")
        self._writer = csv.writer(self._csv)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._writer.writerow([time.time(), step, tag, float(value)])
        self._csv.flush()

    def images(self, tag: str, imgs, step: int) -> None:
        """imgs: (N, H, W, C) float array in [0, 1]."""
        if self._tb is not None:
            self._tb.add_images(tag, imgs, global_step=step, dataformats="NHWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._csv.close()


def run_log_dir(base: str = "logs") -> str:
    """Reference-style run dir: logs/run_<ts> (train.py:31)."""
    return os.path.join(base, f"run_{str(time.time())[-10:]}")
