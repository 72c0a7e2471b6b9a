"""Thresholded health monitors over the event stream, the port's copy of
``src/repro/obs/health.py``: fed one stream, both packages give the same
alerts and verdicts.

Each monitor watches one failure mode, consumes events incrementally, and
produces:

* :class:`Alert`\\ s as thresholds trip (fired through callbacks and,
  when wired into an :class:`~repro_torch.obs.Obs`, re-emitted as
  ``alert`` events so they land in the JSONL too), and
* a **verdict** (``ok`` / ``warn`` / ``degraded``) summarizing the run.

Monitors are pure functions of the event stream, so the same classes
run live (callbacks during training/serving) and offline
(:func:`replay` over a JSONL for ``repro_torch.obs.report``'s health
table).

The built-in set and their default thresholds:

=====================  ======================================================
NonfiniteMonitor       nonfinite hypergradients / gated meta updates.
                       warn on any skip; degraded on >= 3 consecutive or
                       >25% of recent steps (window 100). A skipped step is
                       recovery by design (scale backoff re-arms it) — a
                       *run* of skips means the automaton is not recovering.
LossScaleThrashMonitor loss-scale backoffs (``repro_torch.scale``). warn on
                       >= 3 backoffs inside a 200-step window, degraded on
                       >= 6: growth→overflow→backoff cycling wastes the
                       steps the paper's throughput claim counts.
CensusMonitor          collective census vs the pinned ``unroll+1``.
                       Any mismatch is degraded immediately — a new
                       all-reduce is a structural regression of the
                       single-sync schedule, never noise.
ServeSLOMonitor        deadline-miss + shed rate over the last 100
                       terminal request events. warn > 10%, degraded > 30%.
QueueDepthMonitor      queue occupancy from serve tick events. warn when
                       depth/capacity >= 0.8 for 5 consecutive ticks,
                       degraded at >= 0.95 (shedding is imminent —
                       overflow shed triggers at capacity).
=====================  ======================================================
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

from .events import Event

SEVERITIES = ("ok", "warn", "degraded")


def worst(a: str, b: str) -> str:
    return a if SEVERITIES.index(a) >= SEVERITIES.index(b) else b


@dataclasses.dataclass(frozen=True)
class Alert:
    monitor: str
    severity: str       # "warn" | "degraded"
    message: str
    t: float
    step: Optional[int] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Monitor:
    """One failure mode. Subclasses implement ``observe`` returning any
    alerts this event tripped, and keep enough state for ``verdict``."""

    name = "monitor"

    def observe(self, event: Event) -> List[Alert]:
        raise NotImplementedError

    def verdict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _alert(self, severity: str, message: str, event: Event,
               **data: Any) -> Alert:
        return Alert(monitor=self.name, severity=severity, message=message,
                     t=event.t, step=event.step, data=data)


def _is_nonfinite(v: Any) -> bool:
    return isinstance(v, (int, float)) and not math.isfinite(v)


class NonfiniteMonitor(Monitor):
    """Nonfinite hypergradients and gated (skipped) meta updates."""

    name = "nonfinite"

    def __init__(self, consecutive_limit: int = 3, window: int = 100,
                 rate_limit: float = 0.25):
        self.consecutive_limit = consecutive_limit
        self.rate_limit = rate_limit
        self._recent: "deque[bool]" = deque(maxlen=window)  # True = bad step
        self._consecutive = 0
        self.total_bad = 0
        self.total_steps = 0
        self._severity = "ok"
        self._saw_metrics = False

    def _bad_step(self, event: Event) -> bool:
        if event.kind == "gate":
            return not event.data.get("finite", True)
        if event.kind == "metrics":
            if event.data.get("meta_skipped", 0):
                return True
            return _is_nonfinite(event.data.get("hypergrad_norm")) or \
                _is_nonfinite(event.data.get("meta_loss"))
        return False

    def observe(self, event: Event) -> List[Alert]:
        if event.kind not in ("gate", "metrics"):
            return []
        if event.kind == "metrics" and event.name != "step":
            return []  # registry snapshots etc. are not steps
        if event.kind == "metrics":
            self._saw_metrics = True
        elif self._saw_metrics:
            # live streams emit a metrics/step AND a gate event for the
            # same skipped step — the step event (meta_skipped) already
            # counted it; gate events only define the timeline on
            # gate-only (synthetic/test) streams
            return []
        bad = self._bad_step(event)
        self._recent.append(bad)
        self.total_steps += 1
        alerts: List[Alert] = []
        if bad:
            self.total_bad += 1
            self._consecutive += 1
            if self._consecutive == 1:
                self._severity = worst(self._severity, "warn")
                alerts.append(self._alert(
                    "warn", "nonfinite hypergradient / meta update skipped",
                    event, consecutive=self._consecutive))
            if self._consecutive == self.consecutive_limit:
                self._severity = "degraded"
                alerts.append(self._alert(
                    "degraded",
                    f"{self._consecutive} consecutive skipped meta updates "
                    "— loss-scale automaton is not recovering",
                    event, consecutive=self._consecutive))
        else:
            self._consecutive = 0
        if len(self._recent) == self._recent.maxlen:
            rate = sum(self._recent) / len(self._recent)
            if rate > self.rate_limit and self._severity != "degraded":
                self._severity = "degraded"
                alerts.append(self._alert(
                    "degraded",
                    f"{rate:.0%} of the last {len(self._recent)} steps were "
                    "nonfinite/skipped", event, rate=rate))
        return alerts

    def verdict(self) -> Dict[str, Any]:
        return {"status": self._severity, "bad_steps": self.total_bad,
                "steps": self.total_steps,
                "detail": f"{self.total_bad}/{self.total_steps} steps "
                          "nonfinite or skipped"}


class LossScaleThrashMonitor(Monitor):
    """Backoff frequency from the f16 loss-scale automaton."""

    name = "loss_scale"

    def __init__(self, window_steps: int = 200, warn_backoffs: int = 3,
                 degraded_backoffs: int = 6):
        self.window_steps = window_steps
        self.warn_backoffs = warn_backoffs
        self.degraded_backoffs = degraded_backoffs
        self._backoff_steps: "deque[int]" = deque()
        self._seq = 0  # fallback clock when events carry no step
        self.total_backoffs = 0
        self.total_growths = 0
        self.last_scale: Optional[float] = None
        self._severity = "ok"

    def observe(self, event: Event) -> List[Alert]:
        if event.kind != "scale":
            return []
        self._seq += 1
        step = event.step if event.step is not None else self._seq
        self.last_scale = event.data.get("scale", self.last_scale)
        if event.name == "growth":
            self.total_growths += 1
            return []
        if event.name != "backoff":
            return []
        self.total_backoffs += 1
        self._backoff_steps.append(step)
        while self._backoff_steps and step - self._backoff_steps[0] > self.window_steps:
            self._backoff_steps.popleft()
        n = len(self._backoff_steps)
        alerts: List[Alert] = []
        if n >= self.degraded_backoffs and self._severity != "degraded":
            self._severity = "degraded"
            alerts.append(self._alert(
                "degraded",
                f"loss scale thrashing: {n} backoffs within "
                f"{self.window_steps} steps", event, backoffs_in_window=n,
                scale=self.last_scale))
        elif n >= self.warn_backoffs and self._severity == "ok":
            self._severity = "warn"
            alerts.append(self._alert(
                "warn",
                f"{n} loss-scale backoffs within {self.window_steps} steps",
                event, backoffs_in_window=n, scale=self.last_scale))
        return alerts

    def verdict(self) -> Dict[str, Any]:
        return {"status": self._severity, "backoffs": self.total_backoffs,
                "growths": self.total_growths, "last_scale": self.last_scale,
                "detail": f"{self.total_backoffs} backoffs / "
                          f"{self.total_growths} growths"}


class CensusMonitor(Monitor):
    """Collective census vs the schedule's pinned expectation."""

    name = "census"

    def __init__(self):
        self.observed: Optional[int] = None
        self.expected: Optional[int] = None
        self._severity = "ok"
        self._checked = 0

    def observe(self, event: Event) -> List[Alert]:
        if event.kind != "census":
            return []
        self._checked += 1
        self.observed = event.data.get("observed")
        self.expected = event.data.get("expected")
        ok = event.data.get("ok")
        if ok is None:
            ok = (self.observed == self.expected)
        if not ok:
            self._severity = "degraded"
            return [self._alert(
                "degraded",
                f"collective census mismatch: {self.observed} all-reduces, "
                f"expected {self.expected} (unroll+1)", event,
                observed=self.observed, expected=self.expected)]
        return []

    def verdict(self) -> Dict[str, Any]:
        if self._checked == 0:
            detail = "no census observed"
        else:
            detail = f"{self.observed} all-reduces (expected {self.expected})"
        return {"status": self._severity, "observed": self.observed,
                "expected": self.expected, "detail": detail}


class ServeSLOMonitor(Monitor):
    """Deadline-miss + shed rate over recent terminal request events.

    Terminal events: ``serve/done`` (completed in deadline),
    ``serve/deadline_miss``, ``serve/shed``.

    **Burn-rate mode** (``budget`` set): alongside the plain rate
    thresholds, the monitor tracks the miss rate over a *fast* window
    (catches spikes quickly) and the main *slow* window (confirms they
    are sustained, not one unlucky batch). When BOTH windows burn the
    deadline-miss budget faster than ``burn_threshold``× the allowed
    rate, it fires a ``degraded`` alert immediately — the multi-window
    multi-burn-rate SLO alerting shape, and the signal the flight
    recorder's alert-escalation trigger dumps a postmortem on.
    """

    name = "serve_slo"

    TERMINAL = ("done", "deadline_miss", "shed")

    def __init__(self, window: int = 100, warn_rate: float = 0.10,
                 degraded_rate: float = 0.30, min_events: int = 10,
                 budget: Optional[float] = None, fast_window: int = 20,
                 burn_threshold: float = 4.0):
        self.warn_rate = warn_rate
        self.degraded_rate = degraded_rate
        self.min_events = min_events
        self.budget = budget
        self.burn_threshold = burn_threshold
        self._recent: "deque[bool]" = deque(maxlen=window)  # True = miss/shed
        self._fast: "deque[bool]" = deque(maxlen=fast_window)
        self._burning = False
        self.burn_alerts = 0
        self.totals = {k: 0 for k in self.TERMINAL}
        self._severity = "ok"

    def observe(self, event: Event) -> List[Alert]:
        if event.kind != "serve" or event.name not in self.TERMINAL:
            return []
        bad = event.name != "done"
        self.totals[event.name] += 1
        self._recent.append(bad)
        self._fast.append(bad)
        alerts: List[Alert] = []
        alerts.extend(self._observe_burn(event))
        if len(self._recent) < self.min_events:
            return alerts
        rate = sum(self._recent) / len(self._recent)
        if rate > self.degraded_rate and self._severity != "degraded":
            self._severity = "degraded"
            alerts.append(self._alert(
                "degraded", f"{rate:.0%} of recent requests missed deadline "
                "or were shed", event, rate=rate))
        elif rate > self.warn_rate and self._severity == "ok":
            self._severity = "warn"
            alerts.append(self._alert(
                "warn", f"{rate:.0%} of recent requests missed deadline or "
                "were shed", event, rate=rate))
        return alerts

    def _observe_burn(self, event: Event) -> List[Alert]:
        if self.budget is None or len(self._fast) < self._fast.maxlen \
                or len(self._recent) < self.min_events:
            return []
        fast_rate = sum(self._fast) / len(self._fast)
        slow_rate = sum(self._recent) / len(self._recent)
        burn = self.burn_threshold * self.budget
        if fast_rate >= burn and slow_rate >= burn:
            if self._burning:
                return []  # one alert per sustained burn episode
            self._burning = True
            self.burn_alerts += 1
            self._severity = "degraded"
            return [self._alert(
                "degraded",
                f"SLO burn: miss rate {fast_rate:.0%} (fast) / "
                f"{slow_rate:.0%} (slow) >= {self.burn_threshold:g}x the "
                f"{self.budget:.0%} budget", event,
                fast_rate=fast_rate, slow_rate=slow_rate,
                budget=self.budget, burn_threshold=self.burn_threshold)]
        if fast_rate < burn:
            self._burning = False  # episode over; re-arm
        return []

    def verdict(self) -> Dict[str, Any]:
        n = sum(self.totals.values())
        bad = self.totals["deadline_miss"] + self.totals["shed"]
        out = {"status": self._severity, "requests": n, **self.totals,
               "detail": f"{bad}/{n} requests missed deadline or shed"}
        if self.budget is not None:
            out["budget"] = self.budget
            out["burn_alerts"] = self.burn_alerts
        return out


class QueueDepthMonitor(Monitor):
    """Sustained queue saturation from ``serve/tick`` events carrying
    ``queue_depth`` and ``capacity``."""

    name = "queue_depth"

    def __init__(self, warn_frac: float = 0.80, degraded_frac: float = 0.95,
                 sustain: int = 5):
        self.warn_frac = warn_frac
        self.degraded_frac = degraded_frac
        self.sustain = sustain
        self._warn_run = 0
        self._degraded_run = 0
        self.max_frac = 0.0
        self._severity = "ok"

    def observe(self, event: Event) -> List[Alert]:
        if event.kind != "serve" or event.name != "tick":
            return []
        depth = event.data.get("queue_depth")
        cap = event.data.get("capacity")
        if depth is None or not cap:
            return []
        frac = depth / cap
        self.max_frac = max(self.max_frac, frac)
        self._warn_run = self._warn_run + 1 if frac >= self.warn_frac else 0
        self._degraded_run = self._degraded_run + 1 if frac >= self.degraded_frac else 0
        alerts: List[Alert] = []
        if self._degraded_run == self.sustain:
            self._severity = "degraded"
            alerts.append(self._alert(
                "degraded", f"queue at {frac:.0%} capacity for "
                f"{self.sustain} consecutive ticks — overflow shedding "
                "imminent", event, frac=frac, depth=depth, capacity=cap))
        elif self._warn_run == self.sustain and self._severity == "ok":
            self._severity = "warn"
            alerts.append(self._alert(
                "warn", f"queue at {frac:.0%} capacity for "
                f"{self.sustain} consecutive ticks", event,
                frac=frac, depth=depth, capacity=cap))
        return alerts

    def verdict(self) -> Dict[str, Any]:
        return {"status": self._severity, "max_frac": self.max_frac,
                "detail": f"peak queue occupancy {self.max_frac:.0%}"}


def default_monitors(slo_budget: Optional[float] = None) -> List[Monitor]:
    """The built-in monitor set. ``slo_budget`` (an allowed deadline-miss
    fraction, e.g. 0.05) arms ServeSLOMonitor's burn-rate mode."""

    return [NonfiniteMonitor(), LossScaleThrashMonitor(), CensusMonitor(),
            ServeSLOMonitor(budget=slo_budget), QueueDepthMonitor()]


class HealthMonitor:
    """Fans events out to a set of monitors; collects alerts and the
    aggregate status. ``on_alert`` callbacks run synchronously for each
    fired alert (keep them cheap — they run inside the observed loop)."""

    def __init__(self, monitors: Optional[List[Monitor]] = None,
                 on_alert: Optional[Callable[[Alert], None]] = None):
        self.monitors = monitors if monitors is not None else default_monitors()
        self._callbacks: List[Callable[[Alert], None]] = []
        if on_alert is not None:
            self._callbacks.append(on_alert)
        self.alerts: List[Alert] = []

    def add_callback(self, fn: Callable[[Alert], None]) -> None:
        self._callbacks.append(fn)

    def observe(self, event: Event) -> List[Alert]:
        fired: List[Alert] = []
        for m in self.monitors:
            fired.extend(m.observe(event))
        for a in fired:
            self.alerts.append(a)
            for fn in self._callbacks:
                fn(a)
        return fired

    @property
    def status(self) -> str:
        s = "ok"
        for m in self.monitors:
            s = worst(s, m.verdict()["status"])
        return s

    def summary(self) -> Dict[str, Any]:
        """The degraded-status summary: aggregate status + per-monitor
        verdicts + the alert log."""

        return {
            "status": self.status,
            "t": time.time(),
            "monitors": {m.name: m.verdict() for m in self.monitors},
            "alerts": [a.as_dict() for a in self.alerts],
        }


def replay(events: Iterable[Event],
           monitors: Optional[List[Monitor]] = None) -> HealthMonitor:
    """Run monitors over a recorded stream (the offline path used by
    ``repro.obs.report`` to print health verdicts from a JSONL)."""

    hm = HealthMonitor(monitors=monitors)
    for e in events:
        hm.observe(e)
    return hm
