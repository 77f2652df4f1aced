"""Step timing for the training loops.

Counterpart of ``diffute_tpu/utils/profiling.py``'s ``StepTimer``; its
device-trace context manager is not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Rolling per-step wall-clock stats for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
