"""Nested span timing over the engine's phases, with Chrome-trace export;
the port's counterpart of ``src/repro/obs/trace.py``.

Two layers cooperate:

1. **Profiler ranges.** :func:`phase` always enters
   ``torch.profiler.record_function(name)``, whether or not observability
   is on, so a ``torch.profiler`` trace carries the engine's phase names
   (``chip_smoke.py`` sums device time by them). Outside a profiler the
   range costs a few microseconds and changes nothing that runs.
2. **Host spans.** When a :class:`Tracer` is activated (a contextvar, see
   :func:`activate`), :func:`phase` also records a host wall-time span.
   With no tracer active the extra cost is one contextvar read.

What a span's duration means: the port runs eagerly, so a span measures
the host's time to issue the phase's work, which returns before the
device finishes it. :meth:`repro_torch.api.MetaLearner.phase_profile`
activates a tracer that synchronises the device at each span's end, and
there each span is the phase's wall time. ``Span.traced`` is the JAX
package's flag for a span recorded while ``jit`` traced (compile-time
work); its counterpart here is a span recorded while the current CUDA
stream was being captured into a graph (``torch.cuda.
is_current_stream_capturing``), whose body recorded work without running
it. Every other span has ``traced=False``.

Spans nest: ``depth`` and ``parent`` rebuild the tree, and
:func:`chrome_trace` emits ``traceEvents`` (``ph="X"``, µs timestamps)
for chrome://tracing or Perfetto.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.profiler import record_function

#: Engine phase names, in execution order. report.py orders its span table
#: by them; other names are fine.
PHASES = (
    "base_unroll",      # K-step inner unroll (core/engine._unroll_base)
    "local_terms",      # per-method local hypergradient terms (any method);
                        # SAMA's meta_pass and cd_passes nest inside it
    "meta_pass",        # SAMA perturbation direction (core/sama.py)
    "cd_passes",        # central-difference hypergradient passes
    "finalize",         # method.finalize / hypergradient assembly
    "meta_update",      # guarded_meta_update (gate + optimizer apply)
    "allreduce_flat",   # flat-bucket all-reduce (launch/distributed.py)
)


@dataclasses.dataclass
class Span:
    name: str
    start_s: float          # perf_counter seconds (monotonic, not unix)
    dur_s: float
    depth: int
    parent: Optional[str]
    traced: bool            # recorded during a CUDA-graph capture
    step: Optional[int] = None

    @property
    def dur_us(self) -> float:
        return self.dur_s * 1e6

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "start_s": self.start_s, "dur_s": self.dur_s,
                "dur_us": self.dur_us, "depth": self.depth, "parent": self.parent,
                "traced": self.traced, "step": self.step}


class Tracer:
    """Collects nested spans; optionally mirrors each completed span as a
    ``span`` event into an obs pipeline. ``sync`` (a callable, such as
    ``torch.cuda.synchronize``) runs at each span's end before its time is
    taken, so that the span covers the device's work too."""

    def __init__(self, obs=None, sync: Optional[Callable[[], None]] = None):
        self.spans: List[Span] = []
        self._stack: List[str] = []
        self._obs = obs
        self._sync = sync
        self._cuda = torch.cuda.is_available()
        self.step: Optional[int] = None  # callers set this per step for labeling

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """One span, inside a profiler range of its name."""

        with record_function(name), self._timed(name):
            yield

    @contextlib.contextmanager
    def _timed(self, name: str) -> Iterator[None]:
        parent = self._stack[-1] if self._stack else None
        depth = len(self._stack)
        self._stack.append(name)
        traced = self._cuda and torch.cuda.is_current_stream_capturing()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None and not traced:
                self._sync()
            dur = time.perf_counter() - t0
            self._stack.pop()
            sp = Span(name=name, start_s=t0, dur_s=dur, depth=depth,
                      parent=parent, traced=traced, step=self.step)
            self.spans.append(sp)
            if self._obs is not None and self._obs.enabled:
                self._obs.emit("span", name, data={
                    "dur_us": sp.dur_us, "depth": depth, "parent": parent,
                    "traced": traced}, step=self.step)

    def runtime_spans(self) -> List[Span]:
        """Spans of work that ran (not recorded into a CUDA graph)."""

        return [s for s in self.spans if not s.traced]

    def clear(self) -> None:
        self.spans.clear()


_ACTIVE: "contextvars.ContextVar[Optional[Tracer]]" = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)


def active_tracer() -> Optional[Tracer]:
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(tracer: Tracer) -> Iterator[Tracer]:
    """Make ``tracer`` the target of :func:`phase` spans in this context."""

    token = _ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)


#: the open phases, innermost last. Process-global, not a contextvar: the
#: autograd engine runs a CUDA backward on a thread of its own, and the
#: attribution (``obs/profile.py``) charges that backward's work to the
#: phase that called it
PHASE_STACK: List[str] = []

#: called at each phase's entry (before the push) and exit (before the
#: pop) while the attribution reads per-phase memory peaks; else None
_BOUNDARY: Optional[Callable[[], None]] = None


def set_boundary(hook: Optional[Callable[[], None]]):
    """Install ``hook`` at the phase boundaries; returns the one it replaces."""
    global _BOUNDARY
    prev, _BOUNDARY = _BOUNDARY, hook
    return prev


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate an engine phase: always a ``record_function`` range (the
    profiler's phase names, with obs on or off) and an entry of
    :data:`PHASE_STACK`; also a host span iff a Tracer is activated in the
    current context."""

    tracer = _ACTIVE.get()
    if _BOUNDARY is not None:
        _BOUNDARY()
    PHASE_STACK.append(name)
    try:
        with record_function(name):
            if tracer is None:
                yield
            else:
                with tracer._timed(name):
                    yield
    finally:
        if _BOUNDARY is not None:
            _BOUNDARY()
        PHASE_STACK.pop()


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------


def chrome_trace(spans: Sequence[Span]) -> Dict[str, Any]:
    """Render spans as a Chrome-trace/Perfetto ``traceEvents`` document:
    complete events (``ph="X"``) with µs timestamps relative to the
    earliest span; spans recorded during a graph capture land on their own
    "tid" row."""

    events: List[Dict[str, Any]] = []
    t0 = min((s.start_s for s in spans), default=0.0)
    for s in spans:
        events.append({
            "name": s.name,
            "ph": "X",
            "ts": (s.start_s - t0) * 1e6,
            "dur": s.dur_us,
            "pid": 0,
            "tid": 1 if s.traced else 0,
            "args": {k: v for k, v in (("step", s.step), ("parent", s.parent),
                                       ("traced", s.traced)) if v is not None},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"producer": "repro_torch.obs.trace", "schema": 1},
    }


def lane_chrome_events(events: Sequence[Any]) -> List[Dict[str, Any]]:
    """Per-decode-lane request tracks from a serve event stream.

    Consumes the lifecycle events the serving executor emits (admitted /
    first_token / terminal, each carrying a ``trace_id``) and renders one
    Chrome-trace row per decode lane (``pid=1``, ``tid=slot``) with a
    request span from admission to its terminal event. Beside the tick
    spans, the lane occupancy is the timeline itself: gaps are trash-page
    ticks."""

    TERMINALS = ("done", "deadline_miss", "shed", "rejected", "error")
    reqs: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.kind != "serve":
            continue
        tid = e.data.get("trace_id")
        if tid is None:
            continue
        r = reqs.setdefault(tid, {"start": None, "end": None, "slot": None,
                                  "status": None, "tokens": None,
                                  "request_id": e.data.get("request_id")})
        if e.name == "admitted" and r["start"] is None:
            r["start"] = e.t
        elif e.name == "first_token":
            r["slot"] = e.data.get("slot", r["slot"])
            if r["start"] is None:
                r["start"] = e.t
        elif e.name in TERMINALS:
            r["end"] = e.t
            r["status"] = e.data.get("status", e.name)
            r["tokens"] = e.data.get("tokens")
            if r["slot"] is None:
                r["slot"] = e.data.get("slot")

    spans = [(tid, r) for tid, r in reqs.items()
             if r["slot"] is not None and r["start"] is not None
             and r["end"] is not None]
    if not spans:
        return []
    t0 = min(r["start"] for _, r in spans)
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "serve lanes"}},
    ]
    for slot in sorted({r["slot"] for _, r in spans}):
        out.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": slot,
                    "args": {"name": f"lane {slot}"}})
    for tid, r in sorted(spans, key=lambda kv: kv[1]["start"]):
        out.append({
            "name": f"req {r['request_id']}" if r["request_id"] is not None
            else f"req {tid[:8]}",
            "ph": "X",
            "ts": (r["start"] - t0) * 1e6,
            "dur": max(0.0, (r["end"] - r["start"]) * 1e6),
            "pid": 1,
            "tid": r["slot"],
            "args": {k: v for k, v in (("trace_id", tid),
                                       ("status", r["status"]),
                                       ("tokens", r["tokens"]))
                     if v is not None},
        })
    return out


def write_chrome_trace(path: str, spans: Sequence[Span],
                       extra_events: Optional[Sequence[Dict[str, Any]]] = None
                       ) -> str:
    """Write a Chrome-trace document for ``spans``; ``extra_events`` are
    appended to ``traceEvents`` verbatim (e.g. :func:`lane_chrome_events`
    request tracks)."""

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    doc = chrome_trace(spans)
    if extra_events:
        doc["traceEvents"].extend(extra_events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return path


def span_tree_summary(spans: Sequence[Span]) -> List[Dict[str, Any]]:
    """Aggregate spans by name: {name, n, total_us, mean_us, max_us, depth,
    parent}, ordered by PHASES then first appearance."""

    order: List[str] = []
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        if s.name not in agg:
            order.append(s.name)
            agg[s.name] = {"name": s.name, "n": 0, "total_us": 0.0,
                           "max_us": 0.0, "depth": s.depth, "parent": s.parent}
        a = agg[s.name]
        a["n"] += 1
        a["total_us"] += s.dur_us
        a["max_us"] = max(a["max_us"], s.dur_us)
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["n"]

    def _rank(name: str) -> tuple:
        try:
            return (0, PHASES.index(name))
        except ValueError:
            return (1, order.index(name))

    return [agg[name] for name in sorted(agg, key=_rank)]
