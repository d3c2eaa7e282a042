"""Timing utilities (reference: include/small_gicp/benchmark/benchmark.hpp
:18-94, Stopwatch and Summarizer).

Counterpart of ``small_gicp_tpu/utils/benchmark.py``, with the same
"mean +- std (median=…)" strings, so that the CLIs' lines compare with the
JAX package's and the reference's.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np


class Stopwatch:
    """Lap-based wall-clock timer (benchmark.hpp:18-40)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t1 = self.t0

    def start(self):
        self.t0 = time.perf_counter()
        self.t1 = self.t0

    def lap(self) -> float:
        """Seconds since the last lap or start."""
        now = time.perf_counter()
        dt = now - self.t1
        self.t1 = now
        return dt

    def stop(self) -> float:
        return self.lap()

    def msec(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3


class Summarizer:
    """Streaming mean/std/median accumulator (benchmark.hpp:42-94)."""

    def __init__(self):
        self.values: List[float] = []

    def push(self, x: float):
        self.values.append(float(x))

    @property
    def count(self) -> int:
        return len(self.values)

    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    def std(self) -> float:
        return float(np.std(self.values)) if self.values else 0.0

    def median(self) -> float:
        return float(np.median(self.values)) if self.values else 0.0

    def __str__(self) -> str:
        if not self.values:
            return "0.000 +- 0.000 (median=0.000)"
        return f"{self.mean():.3f} +- {self.std():.3f} (median={self.median():.3f})"
