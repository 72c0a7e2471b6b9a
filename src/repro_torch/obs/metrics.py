"""Host-side metric registry: counters, gauges, histograms; the port's
copy of ``src/repro/obs/metrics.py``.

The training loop must not gain host-device synchronization points. The
metrics here are therefore host values. Device scalars enter only at
boundaries where the loop already waits: ``run_loop``'s ``log_every``
cadence and the serving executor's per-tick harvest. They arrive through
:func:`packed_read`, which brings a dict of 0-d tensors to the host in ONE
device-to-host copy instead of one sync per key.

Instrument types:

* :class:`Counter`: monotone ``inc(n)``; totals per label.
* :class:`Gauge`: ``set(v)`` last-write-wins; also tracks min/max.
* :class:`Histogram`: fixed log-spaced or explicit bucket boundaries,
  O(1) memory, ``observe(v)``; percentile estimates from the bucket CDF.

All instruments accept a ``labels`` mapping so one name can fan out:
``dispatch_total{kernel=adam_adapt,backend=cuda,reason=cuda tensor}``.
Label values are stringified; each instrument guards its values with a
lock (the hang watchdog's thread may read while the loop writes).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

LabelPairs = Tuple[Tuple[str, str], ...]


def label_key(labels: Optional[Mapping[str, Any]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter with optional labels."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelPairs, float] = {}
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, labels: Optional[Mapping[str, Any]] = None) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        key = label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def inc_key(self, key: LabelPairs, n: float = 1.0) -> None:
        """``inc`` by ``n`` >= 0 with the labels already made into a key
        (:func:`label_key`): the hot path of a caller that counts the same
        labels on every call (kernel routing)."""
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, labels: Optional[Mapping[str, Any]] = None) -> float:
        return self._values.get(label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "values": [{"labels": dict(k), "value": v}
                           for k, v in sorted(self._values.items())]}


class Gauge:
    """Last-write-wins scalar; remembers the min/max ever set so a
    snapshot shows excursions the final value hides (queue depth spikes)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelPairs, Tuple[float, float, float]] = {}  # (last, min, max)
        self._lock = threading.Lock()

    def set(self, v: float, labels: Optional[Mapping[str, Any]] = None) -> None:
        v = float(v)
        key = label_key(labels)
        with self._lock:
            prev = self._values.get(key)
            if prev is None:
                self._values[key] = (v, v, v)
            else:
                self._values[key] = (v, min(prev[1], v), max(prev[2], v))

    def value(self, labels: Optional[Mapping[str, Any]] = None) -> Optional[float]:
        got = self._values.get(label_key(labels))
        return None if got is None else got[0]

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "values": [{"labels": dict(k), "value": v, "min": lo, "max": hi}
                           for k, (v, lo, hi) in sorted(self._values.items())]}


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""

    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = max(2, int(math.ceil(per_decade * math.log10(hi / lo))) + 1)
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


class Histogram:
    """Fixed-bucket histogram (upper-bound boundaries + overflow).

    Default boundaries are log-spaced 100µs..30s — right for the latency
    distributions the serve plane feeds it. ``quantile`` interpolates
    within the containing bucket, which is the usual Prometheus-style
    estimate: exact bucket membership, linear within.
    """

    kind = "histogram"

    DEFAULT_BOUNDS = log_buckets(100.0, 30_000_000.0, per_decade=4)  # µs

    def __init__(self, name: str, help: str = "",
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        if list(bounds) != sorted(bounds) or len(bounds) < 1:
            raise ValueError(f"histogram bounds must be sorted & non-empty: {bounds}")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 overflow
        self._sum = 0.0
        self._n = 0
        self._max = float("-inf")
        self._min = float("inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        # binary search for first bound >= v
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._n += 1
            self._max = max(self._max, v)
            self._min = min(self._min, v)

    @property
    def n(self) -> int:
        return self._n

    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-CDF quantile estimate; 0.0 when empty."""

        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._n == 0:
            return 0.0
        rank = q * self._n
        seen = 0
        for i, c in enumerate(self._counts):
            if seen + c >= rank and c > 0:
                if i >= len(self.bounds):           # overflow bucket
                    return self._max
                lower = self.bounds[i - 1] if i > 0 else 0.0
                upper = self.bounds[i]
                frac = (rank - seen) / c
                # clamp into the observed range: a single sample (or a
                # value landing exactly on a bucket bound) must not
                # report a quantile below the smallest / above the
                # largest value actually seen
                return min(max(lower + frac * (upper - lower), self._min),
                           self._max)
            seen += c
        return self._max if self._max != float("-inf") else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name, "n": self._n,
                "sum": self._sum, "mean": self.mean(),
                "min": self._min if self._n else 0.0,
                "max": self._max if self._n else 0.0,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99),
                "bounds": list(self.bounds), "counts": list(self._counts)}


class MetricsRegistry:
    """Name → instrument. ``counter/gauge/histogram`` are get-or-create
    (idempotent across re-wiring), so subsystems can grab the same
    instrument without coordinating construction order."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            got = self._metrics.get(name)
            if got is None:
                got = cls(name, help, **kwargs)
                self._metrics[name] = got
            elif not isinstance(got, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {got.kind}, "
                    f"requested {cls.kind}")
            return got

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        if bounds is not None:
            return self._get_or_create(Histogram, name, help, bounds=bounds)
        return self._get_or_create(Histogram, name, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump of every instrument (the ``metrics``-kind
        ``registry_snapshot`` event at run end)."""

        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}


def packed_read(metrics: Mapping[str, Any]) -> Dict[str, float]:
    """A dict of 0-d tensors as Python floats through one device-to-host
    copy: the values are stacked on their device and copied together, so
    reading N step metrics costs one sync at a boundary where the loop
    already waits."""

    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))
