"""Training metrics as CSV.

Port of `posecnn_tpu/core/metrics.py:MetricsLogger` (the CSV file only):
`<name>_metrics.csv` in the output directory, one row a display step with
`step` first, then the wall time and the metrics, flushed row by row so a
supervisor can read the latest (`tools/supervise_train.py:latest_row`).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, output_dir: str, name: str = "train"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}_metrics.csv")
        self._file = None
        self._writer = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            new = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=list(rec), extrasaction="ignore")
            if new:
                self._writer.writeheader()
        self._writer.writerow(rec)
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = self._writer = None
