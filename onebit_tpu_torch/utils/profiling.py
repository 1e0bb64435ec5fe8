"""Throughput counter (port of ``onebit_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time
from typing import Optional


class ThroughputMeter:
    """tokens/s (or any unit/s) counter with EMA smoothing."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, units: float) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = units / max(now - self._last, 1e-9)
            self.rate = (inst if self.rate is None
                         else self.ema * self.rate + (1 - self.ema) * inst)
        self._last = now
        return self.rate or 0.0
