"""Tail-latency statistics for serving, after ``src/repro/perf/timers.py``
(the port keeps its own copy). Timing of device work (CUDA events,
synchronize) comes with the port's measurement slice."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Tail-latency percentiles over per-request wall times (us)."""

    p50_us: float
    p90_us: float
    p99_us: float
    mean_us: float
    max_us: float
    n: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def empty() -> "LatencyStats":
        """The zero-request value (n=0, all percentiles 0.0); callers check
        ``n == 0`` before treating the percentiles as measurements."""

        return LatencyStats(p50_us=0.0, p90_us=0.0, p99_us=0.0,
                            mean_us=0.0, max_us=0.0, n=0)

    @staticmethod
    def from_samples(samples_s: Sequence[float]) -> "LatencyStats":
        if len(samples_s) == 0:
            return LatencyStats.empty()
        us = np.asarray(samples_s, dtype=np.float64) * 1e6
        p50, p90, p99 = np.percentile(us, [50, 90, 99])
        return LatencyStats(
            p50_us=float(p50), p90_us=float(p90), p99_us=float(p99),
            mean_us=float(us.mean()), max_us=float(us.max()), n=int(us.size),
        )
