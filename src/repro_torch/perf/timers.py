"""Tail-latency statistics for serving, after ``src/repro/perf/timers.py``
(the port keeps its own copy); and the device timing and card rates that
``chip_smoke.py`` and the ``perf`` tools share: :func:`graph_ms`,
:data:`HBM_BYTES_PER_S`, :data:`PEAK_OPS_PER_S`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

#: H100 SXM (NVIDIA data sheet): HBM rate and dense peaks (bf16/f16 on the
#: tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}


def graph_ms(fn, iters=20, warmup=3):
    """Device ms of ``fn()``: its launches captured once in a CUDA graph and
    replayed, ``warmup`` times and then ``iters`` times between two CUDA
    events, so the host's launch overhead drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(warmup):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
