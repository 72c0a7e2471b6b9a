"""Measured wall-time protocol, after ``src/repro/perf/timers.py`` (the
port keeps its own copy): warmup calls absorb first-touch effects, every
timed call ends in ``torch.cuda.synchronize()`` (where JAX blocks until
ready) so asynchronous launches cannot hide work, and the statistic is the
median with an IQR spread. Eager PyTorch compiles nothing ahead of time:
the first call's seconds (kernel builds at first use, library handles) are
kept apart, as ``first_call_s``, never as a compile time. Also the
tail-latency statistics for serving, and the device timing and card rates
that ``chip_smoke.py`` and the ``perf`` tools share: :func:`graph_ms`,
:data:`HBM_BYTES_PER_S`, :data:`PEAK_OPS_PER_S`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

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


def synchronize() -> None:
    """Wait for the card, where there is one: the port's
    ``block_until_ready``."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Robust run-phase statistics over ``repeats`` synchronized calls (us)."""

    median_us: float
    iqr_us: float
    min_us: float
    max_us: float
    mean_us: float
    repeats: int
    warmup: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_samples(samples_s: Sequence[float], warmup: int) -> "TimingStats":
        us = np.asarray(samples_s, dtype=np.float64) * 1e6
        q1, q3 = np.percentile(us, [25, 75])
        return TimingStats(
            median_us=float(np.median(us)),
            iqr_us=float(q3 - q1),
            min_us=float(us.min()),
            max_us=float(us.max()),
            mean_us=float(us.mean()),
            repeats=int(us.size),
            warmup=int(warmup),
        )


@dataclasses.dataclass(frozen=True)
class StepMeasurement:
    """One measured step function: run stats and the first call's seconds.
    ``lower_s`` and ``compile_s`` keep the JAX record's fields and stay
    None: nothing is lowered or compiled ahead of time."""

    timing: TimingStats
    first_call_s: Optional[float] = None
    lower_s: Optional[float] = None
    compile_s: Optional[float] = None

    @property
    def us_per_step(self) -> float:
        return self.timing.median_us

    def samples_per_s(self, samples_per_step: float) -> float:
        return samples_per_step / (self.timing.median_us / 1e6)


def time_callable(fn: Callable, *args, warmup: int = 1, repeats: int = 5,
                  **kwargs) -> TimingStats:
    """Time ``fn(*args, **kwargs)`` with the warmup/repeat/synchronize
    protocol."""

    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(warmup):
        fn(*args, **kwargs)
        synchronize()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        synchronize()
        samples.append(time.perf_counter() - t0)
    return TimingStats.from_samples(samples, warmup)


def compile_split(fn: Callable, *args, **kwargs):
    """``(lower_s, compile_s, first_call_s)``: the eager counterpart of the
    JAX package's lower/compile split. Nothing is lowered or compiled ahead
    of time, so the first two are None; the third is the seconds of one
    synchronized call, in which kernels build at first use."""

    t0 = time.perf_counter()
    fn(*args, **kwargs)
    synchronize()
    return None, None, time.perf_counter() - t0


def measure(fn: Callable, *args, warmup: int = 2, repeats: int = 5,
            **kwargs) -> StepMeasurement:
    """The full protocol: the first of the ``warmup`` calls timed alone
    (:func:`compile_split`), the rest untimed, then ``repeats`` timed
    calls."""

    first_s = None
    if warmup >= 1:
        _, _, first_s = compile_split(fn, *args, **kwargs)
    timing = time_callable(fn, *args, warmup=max(warmup - 1, 0), repeats=repeats, **kwargs)
    return StepMeasurement(timing=dataclasses.replace(timing, warmup=warmup),
                           first_call_s=first_s)


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
