"""repro_torch.obs: runtime tracing, metrics and health telemetry, the
port's counterpart of ``src/repro/obs/``. Both packages write the same v1
event stream (kinds, names, ``data`` keys, derived splits), and each reads
and validates the other's logs and flight bundles.

The facade is :class:`Obs`: one object bundling an event sink
(`events.py`), a metric registry (`metrics.py`), a span tracer
(`trace.py`) and health monitors (`health.py`). Subsystems take an
``obs=`` knob; when it is omitted they fall back to :data:`NULL_OBS`,
whose ``enabled`` flag is False: every instrumentation site guards on that
flag first, so a run without observability does no per-event work, and
since every hook is host-side (the phase names are ``record_function``
ranges either way) a step launches the same kernels with obs on or off.
``tests/test_torch_obs.py`` holds both.

Typical wiring (what ``launch/train.py --obs-log run.jsonl`` does)::

    from repro_torch import obs as obs_mod
    obs = obs_mod.make_obs(log_path="run.jsonl", console=True)
    obs_mod.set_default(obs)          # deep call sites (kernel dispatch)
    ...
    learner.fit(batches, steps=200, obs=obs)
    obs.emit("run", "run_end", data=obs.health.summary())
    obs.close()

Then offline::

    python -m repro_torch.obs.report run.jsonl

The process-global default (:func:`set_default` / :func:`get_default`)
serves call sites too deep to thread a knob through, such as kernel
routing. It starts as :data:`NULL_OBS`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from . import events as events_mod
from . import flight as flight_mod
from . import health as health_mod
from . import metrics as metrics_mod
from . import trace as trace_mod
from .events import (ConsoleSink, Event, JsonlSink, NullSink, RingSink, Sink,
                     TeeSink, make_event, read_jsonl, read_jsonl_stats,
                     validate_event, validate_jsonl)
from .flight import FlightRecorder, HangWatchdog, load_bundle, validate_bundle
from .health import Alert, HealthMonitor, default_monitors
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, packed_read
from .trace import PHASES, Span, Tracer, activate, active_tracer, \
    chrome_trace, lane_chrome_events, phase, span_tree_summary, \
    write_chrome_trace

__all__ = [
    "Obs", "NULL_OBS", "make_obs", "set_default", "get_default",
    "Event", "Sink", "NullSink", "JsonlSink", "RingSink", "ConsoleSink",
    "TeeSink", "make_event", "read_jsonl", "read_jsonl_stats",
    "validate_event", "validate_jsonl",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "packed_read",
    "Tracer", "Span", "phase", "activate", "active_tracer", "chrome_trace",
    "write_chrome_trace", "span_tree_summary", "PHASES", "lane_chrome_events",
    "HealthMonitor", "Alert", "default_monitors",
    "FlightRecorder", "HangWatchdog", "validate_bundle", "load_bundle",
]


class Obs:
    """One observability pipeline: events → [health] → sink, plus a
    metric registry and a span tracer sharing the same sink.

    ``enabled=False`` (or the :data:`NULL_OBS` singleton) is the
    contract for "off": ``emit`` returns before constructing anything,
    and instrumented code guards loops/dict-building on ``obs.enabled``.
    """

    def __init__(self, sink: Optional[Sink] = None, *, enabled: bool = True,
                 run_id: Optional[str] = None,
                 health: Optional[HealthMonitor] = None,
                 monitor: bool = True):
        self.sink: Sink = sink if sink is not None else RingSink()
        self.enabled = enabled
        self.run_id = run_id
        self.metrics = MetricsRegistry()
        self.health: Optional[HealthMonitor] = (
            health if health is not None
            else (HealthMonitor() if monitor else None))
        self.tracer = Tracer(obs=self)
        self._last_loss_scale: Optional[float] = None
        # (kernel, route, reason) -> (dispatch_total, its label key), for
        # the triples already emitted as dispatch events
        self._dispatch_keys: Dict[tuple, tuple] = {}

    # -- event pipeline ----------------------------------------------------

    def emit(self, kind: str, name: str, *, data: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None) -> Optional[Event]:
        """Build, monitor, and sink one event. No-op when disabled."""

        if not self.enabled:
            return None
        event = make_event(kind, name, data=data, step=step)
        self.sink.write(event)
        if self.health is not None:
            for alert in self.health.observe(event):
                # alerts are themselves events, but bypass health to keep
                # the pipeline loop-free
                self.sink.write(make_event(
                    "alert", alert.monitor, step=alert.step,
                    data={"severity": alert.severity, "message": alert.message,
                          **alert.data}))
        return event

    def log(self, name: str, text: Optional[str] = None,
            step: Optional[int] = None, **data: Any) -> None:
        """Structured replacement for ``print()``: a ``log`` event whose
        console rendering is the original line."""

        if not self.enabled:
            return
        if text is not None:
            data = {"text": text, **data}
        self.emit("log", name, data=data, step=step)

    # -- metrics convenience ----------------------------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        return self.metrics.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.metrics.gauge(name, help)

    def histogram(self, name: str, help: str = "", bounds=None) -> Histogram:
        return self.metrics.histogram(name, help, bounds=bounds)

    # -- step / domain observation helpers --------------------------------

    def observe_step(self, step: int, metrics: Dict[str, float]) -> None:
        """Ingest one training step's metric dict (already host floats:
        :func:`repro_torch.obs.metrics.packed_read`).

        Emits the ``metrics`` event and derives the loss-scale and gate
        events on the host from the ``loss_scale`` / ``meta_skipped``
        scalars the engine returns under dynamic scaling, so the step
        function needs no obs-conditional code at all.
        """

        if not self.enabled:
            return
        self.emit("metrics", "step", data=dict(metrics), step=step)
        scale = metrics.get("loss_scale")
        if scale is not None:
            prev = self._last_loss_scale
            if prev is not None and scale != prev:
                name = "backoff" if scale < prev else "growth"
                self.emit("scale", name, data={"scale": scale, "prev": prev},
                          step=step)
                self.counter("loss_scale_transitions").inc(labels={"kind": name})
            self._last_loss_scale = scale
        skipped = metrics.get("meta_skipped")
        if skipped is not None and skipped:
            self.emit("gate", "meta_update",
                      data={"finite": False, "reason": "nonfinite_hypergrad"},
                      step=step)
            self.counter("meta_updates_skipped").inc()
        hg = metrics.get("hypergrad_norm")
        if isinstance(hg, float) and not math.isfinite(hg):
            self.emit("gate", "meta_update",
                      data={"finite": False, "reason": "nonfinite_hypergrad_norm"},
                      step=step)

    def observe_census(self, observed: int, expected: int,
                       detail: Optional[Dict[str, Any]] = None) -> None:
        """Record a collective-census check against the pinned
        ``unroll+1`` expectation; mismatch trips CensusMonitor."""

        if not self.enabled:
            return
        data = {"observed": int(observed), "expected": int(expected),
                "ok": int(observed) == int(expected)}
        if detail:
            data.update(detail)
        self.emit("census", "all_reduce", data=data)

    def observe_dispatch(self, kernel: str, route: str, reason: str) -> None:
        """One kernel routing decision (``kernels/dispatch.route``). The
        JAX package routes once per compile; the port routes on every
        call, so ``dispatch_total{kernel,backend,reason}`` counts calls,
        and a ``dispatch`` event goes out only the first time this
        pipeline sees a (kernel, route, reason) triple: a step does not
        emit hundreds of events."""

        if not self.enabled:
            return
        key = (kernel, route, reason)
        counted = self._dispatch_keys.get(key)
        if counted is None:
            counted = self._dispatch_keys[key] = (
                self.counter("dispatch_total"),
                metrics_mod.label_key({"kernel": kernel, "backend": route, "reason": reason}))
            self.emit("dispatch", kernel, data={"backend": route, "reason": reason})
        counted[0].inc_key(counted[1])

    def sink_dropped(self) -> int:
        """Events evicted by any RingSink in this pipeline (recursing
        through TeeSink fan-outs). The CLIs report this at run_end so a
        too-small ring shows up as a number, not silently missing data."""

        def count(sink: Sink) -> int:
            if isinstance(sink, RingSink):
                return sink.dropped
            if isinstance(sink, TeeSink):
                return sum(count(s) for s in sink.sinks)
            return 0

        return count(self.sink)

    # -- lifecycle ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"run_id": self.run_id,
                               "metrics": self.metrics.snapshot()}
        if self.health is not None:
            out["health"] = self.health.summary()
        return out

    def flush(self) -> None:
        if self.enabled:
            self.sink.flush()

    def close(self) -> None:
        if self.enabled:
            self.sink.close()


#: The disabled pipeline every ``obs=``-knob defaults to. Shared and
#: stateless-by-construction: emit() returns immediately, so nothing is
#: ever written to its NullSink.
NULL_OBS = Obs(sink=NullSink(), enabled=False, monitor=False)


def make_obs(log_path: Optional[str] = None, *, console: bool = False,
             ring: int = 0, run_id: Optional[str] = None,
             monitor: bool = True, slo_budget: Optional[float] = None) -> Obs:
    """Build an enabled Obs from CLI-ish knobs: JSONL file sink
    (``log_path``), legacy-stdout console sink, and/or a ring buffer.
    With no sinks requested you get a 1024-event ring (events are kept,
    nothing is printed or written). ``slo_budget`` (allowed deadline-miss
    fraction) arms ServeSLOMonitor's burn-rate mode."""

    sinks: List[Sink] = []
    if log_path:
        sinks.append(JsonlSink(log_path))
    if console:
        sinks.append(ConsoleSink())
    if ring:
        sinks.append(RingSink(ring))
    if not sinks:
        sinks.append(RingSink())
    sink: Sink = sinks[0] if len(sinks) == 1 else TeeSink(sinks)
    health = None
    if monitor and slo_budget is not None:
        health = HealthMonitor(monitors=default_monitors(slo_budget))
    return Obs(sink=sink, run_id=run_id, monitor=monitor, health=health)


_default_obs: Obs = NULL_OBS


def set_default(obs: Optional[Obs]) -> None:
    """Install the process-global default pipeline (None resets to
    :data:`NULL_OBS`). Used by call sites too deep for an ``obs=`` knob
    — e.g. kernel dispatch decisions."""

    global _default_obs
    _default_obs = obs if obs is not None else NULL_OBS


def get_default() -> Obs:
    return _default_obs
