"""Wall-clock timer (reference: lib/utils/timer.py) plus a step-rate meter.

The port's copy of `posecnn_tpu/utils/timer.py`.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


class RateMeter:
    """Exponential moving average of steps/sec for training loops."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.rate = None
        self._last = None

    def tick(self, n: int = 1) -> float:
        now = time.time()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                r = n / dt
                self.rate = r if self.rate is None else (1 - self.alpha) * self.rate + self.alpha * r
        self._last = now
        return self.rate or 0.0
