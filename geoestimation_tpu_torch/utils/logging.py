"""Metrics logging: stdout + CSV + optional TensorBoard.

The port of `geoestimation_tpu/utils/logging.py`: the same rows and columns
in `metrics.csv` in the checkpoint dir (an existing file is absorbed on
resume), mirrored to TensorBoard where `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, directory: Optional[str] = None,
                 tensorboard: bool = True, stdout=print):
        self.stdout = stdout
        self._csv_path = None
        self._csv_fields = None
        self._rows = None
        self._tb = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._csv_path = os.path.join(directory, "metrics.csv")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(
                        log_dir=os.path.join(directory, "tb")
                    )
                except Exception:
                    self._tb = None

    def _load_existing(self):
        """Resume support: absorb an existing metrics.csv so fields and
        rows stay aligned across restarts."""
        self._rows = []
        self._csv_fields = ["step", "time"]
        if self._csv_path and os.path.exists(self._csv_path):
            try:
                with open(self._csv_path, newline="") as f:
                    reader = csv.DictReader(f)
                    for k in reader.fieldnames or []:
                        if k not in self._csv_fields:
                            self._csv_fields.append(k)
                    self._rows = list(reader)
            except (OSError, csv.Error):
                pass

    def log(self, step: int, metrics: dict, prefix: str = ""):
        metrics = {
            (f"{prefix}{k}" if prefix else k): float(v)
            for k, v in metrics.items()
        }
        parts = " ".join(f"{k} {v:.5g}" for k, v in metrics.items())
        self.stdout(f"step {step} {parts}")
        if self._csv_path:
            if self._rows is None:
                self._load_existing()
            row = {"step": step, "time": time.time(), **metrics}
            new_fields = [k for k in row if k not in self._csv_fields]
            self._rows.append(row)
            if new_fields or not os.path.exists(self._csv_path):
                # Field set evolved (e.g. first val/* row): rewrite once
                # with the union header — appending under a frozen header
                # would silently drop the new metrics.
                self._csv_fields.extend(new_fields)
                tmp = self._csv_path + ".tmp"
                with open(tmp, "w", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=self._csv_fields)
                    writer.writeheader()
                    writer.writerows(self._rows)
                os.replace(tmp, self._csv_path)
            else:
                # Common case: append one row (O(1) per log call).
                with open(self._csv_path, "a", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=self._csv_fields)
                    writer.writerow(row)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
