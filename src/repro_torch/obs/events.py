"""The versioned structured-event schema and its sinks, the port's copy of
``src/repro/obs/events.py``: both packages write and read one stream.

One :class:`Event` is one timestamped fact about a running system: a
metric snapshot, a completed span, a loss-scale backoff, a shed request,
a health alert. Every event flows through a sink:

* :class:`NullSink`: the disabled path. Writing is a no-op; the hot loops
  also guard on ``obs.enabled``, so a disabled run does no per-event work
  at all, and since every hook is host-side the step launches the same
  kernels either way (``tests/test_torch_obs.py`` holds both).
* :class:`JsonlSink`: append-only JSON Lines file, one event per line,
  flushed per write so a killed run keeps everything it logged. This is
  the durable format ``repro_torch.obs.report`` reads.
* :class:`RingSink`: fixed-capacity in-memory ring (oldest evicted first).
* :class:`ConsoleSink`: renders selected event kinds back into the lines
  the CLIs print (``log`` events print their text, ``metrics`` events the
  JSON dict ``launch/train.py`` prints).
* :class:`TeeSink`: fan-out to several sinks.

Schema v1 (:func:`validate_event`)::

    {"v": 1, "t": <unix seconds>, "kind": <KINDS>, "name": str,
     "step": int | null, "data": {...}}

``kind`` is the coarse router (what machinery produced the event),
``name`` the fine label, ``data`` the payload. Unknown names are fine;
unknown kinds are schema errors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

SCHEMA_VERSION = 1

#: The closed set of event kinds (coarse categories; ``name`` is open).
KINDS = (
    "run",        # run_start / run_end lifecycle markers
    "log",        # structured replacement for print() reporting
    "metrics",    # a step's metric scalars (or a registry snapshot)
    "span",       # a completed trace.Span (host wall time)
    "scale",      # loss-scale automaton transitions (backoff / growth)
    "gate",       # skip-on-nonfinite gates (guarded_meta_update)
    "census",     # collective-census observation (all-reduce counts)
    "serve",      # serving-plane events (lifecycle, sheds, ticks)
    "dispatch",   # kernel routing decisions
    "checkpoint", # save / restore
    "alert",      # health-monitor firings
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured observation. Immutable; ``data`` values must be
    JSON-serializable (the JsonlSink stringifies anything ``json``
    refuses)."""

    kind: str
    name: str
    t: float
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    step: Optional[int] = None
    v: int = SCHEMA_VERSION

    def as_dict(self) -> Dict[str, Any]:
        return {"v": self.v, "t": self.t, "kind": self.kind, "name": self.name,
                "step": self.step, "data": self.data}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Event":
        return Event(kind=d["kind"], name=d["name"], t=d["t"],
                     data=dict(d.get("data") or {}), step=d.get("step"),
                     v=d.get("v", SCHEMA_VERSION))


def make_event(kind: str, name: str, *, data: Optional[Dict[str, Any]] = None,
               step: Optional[int] = None, t: Optional[float] = None) -> Event:
    if kind not in KINDS:
        raise ValueError(f"unknown event kind {kind!r}; have {KINDS}")
    return Event(kind=kind, name=name, t=time.time() if t is None else t,
                 data=dict(data or {}), step=step)


def validate_event(d: Any) -> List[str]:
    """Schema errors for one event dict ([] = valid)."""

    if not isinstance(d, dict):
        return [f"event must be a dict, got {type(d).__name__}"]
    errors: List[str] = []
    if d.get("v") != SCHEMA_VERSION:
        errors.append(f"event.v must be {SCHEMA_VERSION}, got {d.get('v')!r}")
    if d.get("kind") not in KINDS:
        errors.append(f"event.kind {d.get('kind')!r} not in {KINDS}")
    if not isinstance(d.get("name"), str) or not d.get("name"):
        errors.append("event.name must be a non-empty string")
    if not isinstance(d.get("t"), (int, float)):
        errors.append("event.t must be a number (unix seconds)")
    step = d.get("step")
    if step is not None and not isinstance(step, int):
        errors.append("event.step must be an int or null")
    if not isinstance(d.get("data"), dict):
        errors.append("event.data must be a dict")
    return errors


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class Sink:
    """Protocol anchor: ``write(event)``, ``flush()``, ``close()``."""

    def write(self, event: Event) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class NullSink(Sink):
    """Discards everything. ``Obs`` returns before building an Event when
    disabled; this sink keeps a disabled pipeline inert if something
    writes anyway."""

    def write(self, event: Event) -> None:
        pass


class RingSink(Sink):
    """Keep the most recent ``capacity`` events in memory (FIFO eviction).
    ``events()`` returns oldest-first."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: "deque[Event]" = deque(maxlen=capacity)
        self.dropped = 0  # evicted events

    def write(self, event: Event) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(event)

    def events(self) -> List[Event]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()


class JsonlSink(Sink):
    """Append-only JSON Lines file. One ``json.dumps`` per event, flushed
    at once: the event rate is bounded by the host-side cadence
    (``log_every`` for training, per request and tick for serving), so
    durability wins over batching. Values ``json`` refuses are
    stringified rather than crashing the observed run."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write(self, event: Event) -> None:
        self._f.write(json.dumps(event.as_dict(), default=str) + "\n")
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _render_log(e: Event) -> str:
    text = e.data.get("text")
    if text is not None:
        return str(text)
    return f"{e.name}: " + json.dumps(
        {k: v for k, v in e.data.items() if k != "text"}, default=str)


def _render_metrics(e: Event) -> str:
    # the line launch/train.py prints: the metrics, the step, and the
    # wall clock ("elapsed_s") last; without "elapsed_s" the JAX
    # package's line (the step last)
    d = {k: v for k, v in e.data.items() if k != "elapsed_s"}
    if e.step is not None:
        d.setdefault("step", e.step)
    if "elapsed_s" in e.data:
        d["elapsed_s"] = e.data["elapsed_s"]
    return json.dumps(d, default=str)


def _render_alert(e: Event) -> str:
    return (f"[obs:{e.data.get('severity', 'warn')}] {e.name}: "
            f"{e.data.get('message', '')}")


def _render_run(e: Event) -> Optional[str]:
    # the train CLI's startup line (to standard error); run_end prints nothing
    return json.dumps({"run": e.data}, default=str) if e.name == "run_start" else None


class ConsoleSink(Sink):
    """Renders selected kinds into the CLIs' stdout lines. Span, serve and
    dispatch chatter is not printed: the console shows what the CLIs
    print, the JSONL keeps everything. A renderer that returns None
    prints nothing for that event."""

    RENDERERS: Dict[str, Callable[[Event], Optional[str]]] = {
        "log": _render_log,
        "metrics": _render_metrics,
        "alert": _render_alert,
        "run": _render_run,
    }

    #: the kinds printed unless ``kinds`` says otherwise
    DEFAULT_KINDS = ("log", "metrics", "alert")

    #: metrics-kind names worth a console line; registry snapshots and
    #: other bulk dumps stay JSONL-only
    METRIC_NAMES = ("step",)

    def __init__(self, stream=None, kinds: Optional[Tuple[str, ...]] = None):
        self.stream = stream if stream is not None else sys.stdout
        self.kinds = tuple(kinds) if kinds is not None else self.DEFAULT_KINDS

    def write(self, event: Event) -> None:
        if event.kind not in self.kinds:
            return
        if event.kind == "metrics" and event.name not in self.METRIC_NAMES:
            return
        line = self.RENDERERS.get(event.kind, _render_log)(event)
        if line is not None:
            print(line, file=self.stream, flush=True)

    def flush(self) -> None:
        self.stream.flush()


class TeeSink(Sink):
    def __init__(self, sinks: List[Sink]):
        self.sinks = list(sinks)

    def write(self, event: Event) -> None:
        for s in self.sinks:
            s.write(event)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# ---------------------------------------------------------------------------
# reading logs back
# ---------------------------------------------------------------------------


def read_jsonl(path: str, *, strict: bool = False) -> Iterator[Event]:
    """Iterate the events of a JSONL log. ``strict`` raises on the first
    malformed line or schema violation; otherwise bad lines are skipped
    (a crashed writer can leave a torn final line)."""

    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                if strict:
                    raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
                continue
            errors = validate_event(d)
            if errors:
                if strict:
                    raise ValueError(f"{path}:{lineno}: " + "; ".join(errors))
                continue
            yield Event.from_dict(d)


def read_jsonl_stats(path: str) -> Tuple[List[Event], Dict[str, int]]:
    """Like :func:`read_jsonl` (lenient), but also count what was skipped:
    ``torn_lines`` (not JSON) and ``invalid_lines`` (JSON but
    schema-invalid), which the report CLI surfaces."""

    events: List[Event] = []
    stats = {"torn_lines": 0, "invalid_lines": 0}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                stats["torn_lines"] += 1
                continue
            if validate_event(d):
                stats["invalid_lines"] += 1
                continue
            events.append(Event.from_dict(d))
    return events, stats


def validate_jsonl(path: str) -> List[str]:
    """Schema errors across a whole log file ([] = every line valid)."""

    errors: List[str] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: not JSON: {e}")
                continue
            errors.extend(f"line {lineno}: {e}" for e in validate_event(d))
    return errors
