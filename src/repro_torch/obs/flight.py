"""Flight recorder: an always-on bounded ring for serving postmortems; the
port's copy of ``src/repro/obs/flight.py`` (a bundle written by either
package validates in both).

A crashed or hung serving process is exactly the run whose JSONL stream
is most likely to be missing (never configured, torn, or stalled before
the interesting part). The :class:`FlightRecorder` therefore keeps the
*recent past* in memory regardless of whether an obs pipeline is
enabled:

* a bounded ring of the most recent events (oldest evicted, evictions
  counted),
* a small ring of periodic metrics/queue snapshots, and
* a set of live **state providers** — callables the owner registers
  (the executor registers one reporting queue depth, live lanes with
  their ``trace_id``\\ s, and paged-cache stats) that are invoked at
  dump time so the bundle shows *what the system was doing*, not just
  what it said.

``dump(reason)`` freezes all of it into one ordered postmortem bundle
(a single JSON document, atomically written when an ``out_dir`` is
configured), readable offline via
``python -m repro_torch.obs.report --postmortem bundle.json``. Three triggers
produce dumps in the serving stack:

1. **alert escalation** — :meth:`attach` registers an alert callback on
   an Obs pipeline's health monitor; any ``degraded`` alert dumps,
2. **unhandled executor exception** — ``ServeExecutor.run`` dumps
   before re-raising, and
3. **hang** — :class:`HangWatchdog` (its own daemon thread, because a
   hung tick loop by definition runs no Python) dumps when no tick
   progress was beaten within ``deadline_s``.

Dumps are throttled per reason (``min_interval_s``) so an alert storm
produces one bundle, not hundreds. All public methods are thread-safe:
the watchdog thread dumps while the tick thread appends.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .events import Event, make_event, validate_event

BUNDLE_VERSION = 1
BUNDLE_KIND = "postmortem"

#: dump trigger reasons used by the serving stack (open set; these are
#: the three the executor wires up)
REASON_ALERT = "alert"
REASON_EXCEPTION = "exception"
REASON_HANG = "hang"


class FlightRecorder:
    """Bounded in-memory ring of events + snapshots + state providers,
    dumpable as an ordered postmortem bundle. Usable as an event Sink
    (``write``/``flush``/``close``) so it can be teed into an Obs
    pipeline, and writable directly by instrumented code when no
    pipeline is enabled (the always-on path)."""

    def __init__(self, capacity: int = 4096, *, snapshot_capacity: int = 32,
                 out_dir: Optional[str] = None, min_interval_s: float = 5.0,
                 clock: Callable[[], float] = time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.out_dir = out_dir
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._ring: "deque[Event]" = deque(maxlen=capacity)
        self._snaps: "deque[Dict[str, Any]]" = deque(maxlen=snapshot_capacity)
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self._last_dump_t: Dict[str, float] = {}  # reason -> clock reading
        self._seq = 0
        self.dropped = 0
        self.dumps: List[str] = []          # paths written (out_dir set)
        self.last_bundle: Optional[Dict[str, Any]] = None

    # -- sink protocol -------------------------------------------------------

    def write(self, event: Event) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, name: str, *, data: Optional[Dict[str, Any]] = None,
               step: Optional[int] = None) -> None:
        """Build-and-write convenience for the always-on path (no Obs
        pipeline enabled — nothing else constructs the Event)."""

        self.write(make_event(kind, name, data=data, step=step))

    def record_snapshot(self, snapshot: Dict[str, Any]) -> None:
        """Append one metrics/queue snapshot (timestamped here)."""

        with self._lock:
            self._snaps.append({"t": self._clock(), **snapshot})

    def add_state_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a zero-arg callable whose JSON-serializable return
        value is captured at dump time under ``state[name]``. A provider
        that raises contributes an error string instead of killing the
        dump (the dump path must never fail because the system being
        postmortemed is broken)."""

        self._providers[name] = fn

    def events(self) -> List[Event]:
        """Ring contents, oldest first."""

        with self._lock:
            return list(self._ring)

    def attach(self, obs) -> None:
        """Wire the alert-escalation trigger: any ``degraded`` alert from
        ``obs.health`` dumps a bundle."""

        if obs is None or obs.health is None:
            return

        def on_alert(alert) -> None:
            if alert.severity == "degraded":
                self.dump(REASON_ALERT,
                          detail=f"{alert.monitor}: {alert.message}")

        obs.health.add_callback(on_alert)

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, detail: str = "",
             force: bool = False) -> Optional[Dict[str, Any]]:
        """Freeze the ring into a postmortem bundle. Returns the bundle
        dict (also kept as ``last_bundle``), or None when throttled
        (same ``reason`` within ``min_interval_s``, unless ``force``).
        When ``out_dir`` is set the bundle is also written atomically as
        ``postmortem-<reason>-<seq>.json``."""

        now = self._clock()
        with self._lock:
            last = self._last_dump_t.get(reason)
            if not force and last is not None and now - last < self.min_interval_s:
                return None
            self._last_dump_t[reason] = now
            events = list(self._ring)
            snaps = list(self._snaps)
            dropped = self.dropped
            self._seq += 1
            seq = self._seq

        state: Dict[str, Any] = {}
        for name, fn in self._providers.items():
            try:
                state[name] = fn()
            except Exception as e:  # dump must survive a broken system
                state[name] = f"<state provider failed: {e!r}>"

        bundle: Dict[str, Any] = {
            "v": BUNDLE_VERSION,
            "kind": BUNDLE_KIND,
            "trigger": {"reason": reason, "detail": detail, "t": now,
                        "seq": seq},
            "events": [e.as_dict() for e in events],
            "dropped": dropped,
            "metrics_snapshots": snaps,
            "state": state,
            "env": {"pid": os.getpid(), "unix_time": time.time()},
        }
        self.last_bundle = bundle
        if self.out_dir is not None:
            path = os.path.join(self.out_dir,
                                f"postmortem-{reason}-{seq:03d}.json")
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, path)  # atomic: never a torn bundle
            self.dumps.append(path)
        return bundle


def validate_bundle(d: Any) -> List[str]:
    """Schema errors for one postmortem bundle ([] = valid); also what
    ``report --postmortem --validate`` runs."""

    if not isinstance(d, dict):
        return [f"bundle must be a dict, got {type(d).__name__}"]
    errors: List[str] = []
    if d.get("v") != BUNDLE_VERSION:
        errors.append(f"bundle.v must be {BUNDLE_VERSION}, got {d.get('v')!r}")
    if d.get("kind") != BUNDLE_KIND:
        errors.append(f"bundle.kind must be {BUNDLE_KIND!r}, got {d.get('kind')!r}")
    trig = d.get("trigger")
    if not isinstance(trig, dict) or not trig.get("reason") \
            or not isinstance(trig.get("t"), (int, float)):
        errors.append("bundle.trigger must carry reason and numeric t")
    events = d.get("events")
    if not isinstance(events, list):
        errors.append("bundle.events must be a list")
    else:
        for i, ev in enumerate(events):
            for e in validate_event(ev):
                errors.append(f"events[{i}]: {e}")
    if not isinstance(d.get("metrics_snapshots"), list):
        errors.append("bundle.metrics_snapshots must be a list")
    if not isinstance(d.get("state"), dict):
        errors.append("bundle.state must be a dict")
    if not isinstance(d.get("dropped"), int):
        errors.append("bundle.dropped must be an int")
    return errors


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class HangWatchdog:
    """No-tick-progress watchdog. The owner calls :meth:`beat` whenever
    the loop makes progress; :meth:`check` fires ``on_hang(stall_s)``
    when the last beat is older than ``deadline_s``. Fires at most once
    per stall — a new beat re-arms it.

    :meth:`start` runs ``check`` on a daemon thread every ``poll_s``
    (default ``deadline_s / 4``): a loop blocked inside a device read
    runs no Python of its own, so the dump has to come from elsewhere.
    ``on_hang`` runs on that thread while the loop may be inside a CUDA
    call: it must only read host state (and, of the device, only what is
    safe from any thread, such as ``torch.cuda.memory_allocated``), and
    never synchronise the device. Tests drive :meth:`check` directly with
    an injected clock instead.
    """

    def __init__(self, deadline_s: float, on_hang: Callable[[float], None], *,
                 clock: Callable[[], float] = time.monotonic,
                 poll_s: Optional[float] = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.poll_s = poll_s if poll_s is not None else deadline_s / 4.0
        self._on_hang = on_hang
        self._clock = clock
        self._last_beat = clock()
        self._fired = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.fires = 0

    def beat(self) -> None:
        with self._lock:
            self._last_beat = self._clock()
            self._fired = False
            self.beats += 1

    def check(self, now: Optional[float] = None) -> bool:
        """True iff this call fired ``on_hang``."""

        now = self._clock() if now is None else now
        with self._lock:
            stall = now - self._last_beat
            if self._fired or stall <= self.deadline_s:
                return False
            self._fired = True
            self.fires += 1
        self._on_hang(stall)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.poll_s):
                try:
                    self.check()
                except Exception:  # the watchdog must outlive a bad dump
                    pass

        self._thread = threading.Thread(target=loop, name="repro-torch-hang-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def emit_teed(obs, flight: Optional[FlightRecorder], kind: str, name: str, *,
              data: Optional[Dict[str, Any]] = None,
              step: Optional[int] = None) -> None:
    """Emit one event into an Obs pipeline AND a flight ring.

    The single shared emission helper for the serve plane: when obs is
    enabled the event it built is reused for the ring (one construction,
    two destinations); when obs is disabled but a recorder is present —
    the always-on postmortem path — the event is built only for the
    ring. With neither, nothing is constructed.
    """

    ev = obs.emit(kind, name, data=data, step=step)
    if flight is not None:
        flight.write(ev if ev is not None
                     else make_event(kind, name, data=data, step=step))
