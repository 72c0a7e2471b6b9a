"""Request queue with admission control, per-request deadlines, and shed
accounting: the port's copy of the framework-free
``src/repro/serve/queue.py``.

``submit`` either admits a request or sheds it *immediately* (bounded
depth: backpressure instead of unbounded growth), and ``pop`` drops
requests whose deadline already passed before they reached a decode slot.
Both shed paths are recorded as :class:`ShedEvent` so the executor can
resolve the request with a terminal status.

Time is injected (``clock=``) so deadline behavior is deterministic under
test: tests advance a fake clock instead of sleeping.

Every request's trace starts here: ``submit`` emits its ``enqueued``
event (an overflow-shed request's too, so that its timeline reads
enqueued -> shed) into the obs pipeline and the flight ring, and each
shed emits a ``queue_shed`` event and counts ``queue_sheds{reason}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Deque, List, Optional

from repro_torch.obs import NULL_OBS
from repro_torch.obs.flight import emit_teed

SHED_OVERFLOW = "shed_overflow"
SHED_DEADLINE = "shed_deadline"


def mint_trace_id() -> str:
    """A fresh request trace id (16 hex chars)."""

    return uuid.uuid4().hex[:16]


class QueueFull(RuntimeError):
    """Admission refused: the queue is at ``max_depth``. Carries the
    recorded overflow ``.event`` so the caller can resolve the request
    with a terminal status."""

    event: "ShedEvent"


class QueueClosed(RuntimeError):
    """Admission refused: the queue no longer accepts requests."""


@dataclasses.dataclass
class Request:
    """One admitted decode request. ``deadline`` is an absolute clock
    reading (``None`` = no SLO); ``payload`` is opaque to the queue.
    ``trace_id`` is minted at submit and rides on every lifecycle event
    the request produces (enqueued -> admitted -> prefill -> tokens ->
    terminal), so its timeline rebuilds from the event stream alone."""

    id: int
    payload: Any
    submit_t: float
    deadline: Optional[float] = None
    trace_id: str = dataclasses.field(default_factory=mint_trace_id)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    request: Request
    reason: str  # SHED_OVERFLOW | SHED_DEADLINE
    t: float


@dataclasses.dataclass(frozen=True)
class QueueStats:
    submitted: int
    admitted: int
    shed_overflow: int
    shed_deadline: int
    depth: int


class RequestQueue:
    """Bounded FIFO with deadline shedding. Thread-safe: callers may
    ``submit`` from any thread while one serving loop ``pop``s."""

    def __init__(self, max_depth: int = 64, *,
                 default_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs=None, flight=None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.default_timeout_s = default_timeout_s
        self._clock = clock
        self._obs = obs if obs is not None else NULL_OBS
        # the always-on postmortem ring (obs.flight): lifecycle events land
        # there even when no obs pipeline is enabled
        self._flight = flight
        self._ids = itertools.count()
        self._q: Deque[Request] = deque()
        self._shed: List[ShedEvent] = []
        self._lock = threading.Lock()
        self._closed = False
        self._submitted = 0
        self._admitted = 0
        self._n_shed_overflow = 0
        self._n_shed_deadline = 0

    # -- admission -----------------------------------------------------------

    def submit(self, payload: Any, *, timeout_s: Optional[float] = None) -> Request:
        """Admit ``payload`` or raise. ``QueueFull`` counts as an overflow
        shed."""

        now = self._clock()
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        overflow = None
        with self._lock:
            self._submitted += 1
            req = Request(
                id=next(self._ids), payload=payload, submit_t=now,
                deadline=None if timeout_s is None else now + timeout_s,
            )
            if self._closed:
                raise QueueClosed("queue is closed")
            if len(self._q) >= self.max_depth:
                self._n_shed_overflow += 1
                overflow = ShedEvent(req, SHED_OVERFLOW, now)
                self._shed.append(overflow)
                depth = len(self._q)
            else:
                self._admitted += 1
                self._q.append(req)
        # outside the lock: a monitor's callback may read the queue
        self._observe_enqueued(req)
        if overflow is not None:
            self._observe_shed(overflow)
            err = QueueFull(f"queue depth {depth} at max_depth={self.max_depth}")
            err.event = overflow
            raise err
        return req

    def close(self) -> None:
        with self._lock:
            self._closed = True

    # -- consumption ---------------------------------------------------------

    def pop(self, n: int = 1, now: Optional[float] = None) -> List[Request]:
        """Take up to ``n`` live requests in FIFO order, shedding any whose
        deadline passed while queued."""

        now = self._clock() if now is None else now
        out: List[Request] = []
        shed: List[ShedEvent] = []
        with self._lock:
            while self._q and len(out) < n:
                req = self._q.popleft()
                if req.expired(now):
                    self._n_shed_deadline += 1
                    shed.append(ShedEvent(req, SHED_DEADLINE, now))
                    continue
                out.append(req)
            self._shed.extend(shed)
        for ev in shed:
            self._observe_shed(ev)
        return out

    def drain_shed(self) -> List[ShedEvent]:
        """Return-and-clear shed events (the executor resolves each into a
        terminal request status)."""

        with self._lock:
            shed, self._shed = self._shed, []
            return shed

    def _observe_enqueued(self, req: Request) -> None:
        """The first lifecycle event of every request's trace."""

        if not self._obs.enabled and self._flight is None:
            return
        emit_teed(self._obs, self._flight, "serve", "enqueued", data={
            "trace_id": req.trace_id, "request_id": req.id,
            "deadline_s": None if req.deadline is None else req.deadline - req.submit_t,
        })

    def _observe_shed(self, ev: ShedEvent) -> None:
        """A shed, as the queue's own accounting: ``queue_sheds{reason}``
        and a ``queue_shed`` event (the executor emits the request's
        terminal event)."""

        if not self._obs.enabled and self._flight is None:
            return
        if self._obs.enabled:
            self._obs.counter("queue_sheds").inc(labels={"reason": ev.reason})
        emit_teed(self._obs, self._flight, "serve", "queue_shed",
                  data={"reason": ev.reason, "request_id": ev.request.id,
                        "trace_id": ev.request.trace_id})

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def stats(self) -> QueueStats:
        with self._lock:
            return QueueStats(
                submitted=self._submitted,
                admitted=self._admitted,
                shed_overflow=self._n_shed_overflow,
                shed_deadline=self._n_shed_deadline,
                depth=len(self._q),
            )
