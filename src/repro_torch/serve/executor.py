"""The serving loop: deadline enforcement, graceful degradation and
per-request latency, after ``src/repro/serve/executor.py``.

One tick: (1) resolve queue sheds and expired in-flight deadlines,
(2) admit queued requests into freed slots (prefill), (3) harvest the
*previous* decode step, (4) dispatch the next. ``dispatch`` only queues
work on the CUDA stream, so the host work of (1)-(2) overlaps the device
executing the in-flight step; the blocking point is ``harvest``'s
device-to-host copy of the step's token ids.

Degradation is graceful by construction: queue overflow sheds at
admission (``shed_overflow``), deadline misses shed queued *or*
mid-generation requests with partial output (``shed_deadline``), and a
lane producing nonfinite logits is retired and replayed through the
serial dense-cache ``greedy_generate`` path (``ok_serial_fallback``).

The obs hooks, flight recorder, hang watchdog and chrome trace of the JAX
executor come with the observability slice.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.perf.timers import LatencyStats
from repro_torch.serve.batcher import ContinuousBatcher, Lane, ServeConfig
from repro_torch.serve.cache import PagedCacheError
from repro_torch.serve.prefill import greedy_generate
from repro_torch.serve.queue import (
    SHED_DEADLINE,
    SHED_OVERFLOW,
    QueueFull,
    Request,
    RequestQueue,
)

STATUS_OK = "ok"
STATUS_FALLBACK = "ok_serial_fallback"
STATUS_SHED_OVERFLOW = SHED_OVERFLOW
STATUS_SHED_DEADLINE = SHED_DEADLINE
STATUS_REJECTED = "rejected"
STATUS_ERROR = "error"

#: statuses that produced a complete generation
OK_STATUSES = (STATUS_OK, STATUS_FALLBACK)


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one submitted request. ``finish_t`` is set only
    for statuses that produced a complete (or errored-out) generation;
    ``resolved_t`` is set for every terminal status."""

    id: int
    status: str
    tokens: List[int]
    submit_t: float
    admitted_t: Optional[float] = None
    finish_t: Optional[float] = None
    resolved_t: Optional[float] = None
    first_token_t: Optional[float] = None
    slot: Optional[int] = None
    trace_id: str = ""
    detail: str = ""

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def queue_s(self) -> Optional[float]:
        if self.admitted_t is None:
            return None
        return self.admitted_t - self.submit_t

    @property
    def resident_s(self) -> Optional[float]:
        """submit -> terminal, regardless of outcome."""

        if self.resolved_t is None:
            return None
        return self.resolved_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: submit -> first generated token."""

        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token: the decode-phase wall time amortized over
        tokens after the first."""

        if self.first_token_t is None or self.resolved_t is None \
                or len(self.tokens) < 2:
            return None
        return (self.resolved_t - self.first_token_t) / (len(self.tokens) - 1)


@dataclasses.dataclass
class ServeStats:
    completed: int
    fallbacks: int
    shed_overflow: int
    shed_deadline: int
    rejected: int
    errors: int
    steps: int
    qps: float
    latency: LatencyStats       # n == 0 when nothing completed
    queue_wait: LatencyStats
    ttft: LatencyStats
    tpot: LatencyStats
    lanes: List[Dict[str, Any]]
    memory: Dict[str, Any]


class ServeExecutor:
    """Owns the queue, the batcher, and every request's terminal status."""

    def __init__(self, model, params, cfg: Optional[ServeConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        cfg = cfg or ServeConfig()
        self.cfg = cfg
        self.batcher = ContinuousBatcher(model, params, cfg)  # rejects encoders
        self.queue = RequestQueue(cfg.queue_depth,
                                  default_timeout_s=cfg.default_timeout_s,
                                  clock=clock)
        self._clock = clock
        self.results: Dict[int, RequestResult] = {}
        self._stalled: Optional[Request] = None

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue one decode request; returns its id. Malformed requests
        raise immediately (caller bug); overflow records a
        ``shed_overflow`` result instead of raising (load, not bug)."""

        prompt = np.asarray(prompt, np.int64).reshape(-1)
        target = int(self.cfg.max_new_tokens if max_new_tokens is None
                     else max_new_tokens)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if target < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + target > self.cfg.max_len:
            raise ValueError(
                f"prompt_len={prompt.size} + max_new_tokens={target} exceeds "
                f"max_len={self.cfg.max_len}")
        payload = {"prompt": prompt, "max_new_tokens": target}
        try:
            req = self.queue.submit(payload, timeout_s=timeout_s)
        except QueueFull as e:
            self._resolve_shed()
            return e.event.request.id
        return req.id

    def _record(self, req: Request, status: str, tokens: List[int],
                admitted_t: Optional[float], detail: str = "", *,
                slot: Optional[int] = None,
                first_token_t: Optional[float] = None) -> None:
        now = self._clock()
        self.results[req.id] = RequestResult(
            id=req.id, status=status, tokens=list(tokens),
            submit_t=req.submit_t, admitted_t=admitted_t,
            finish_t=now if status in OK_STATUSES + (STATUS_ERROR,) else None,
            resolved_t=now, first_token_t=first_token_t, slot=slot,
            trace_id=req.trace_id, detail=detail,
        )

    def _resolve_shed(self) -> None:
        for ev in self.queue.drain_shed():
            self.results[ev.request.id] = RequestResult(
                id=ev.request.id, status=ev.reason, tokens=[],
                submit_t=ev.request.submit_t, resolved_t=ev.t,
                trace_id=ev.request.trace_id,
            )

    # -- the loop ------------------------------------------------------------

    def _finalize(self, lane: Lane, status: str, detail: str = "") -> None:
        self.batcher.retire(lane)
        self._record(lane.request, status, lane.tokens[: lane.target_new],
                     lane.admitted_t, detail, slot=lane.slot,
                     first_token_t=lane.first_token_t)

    def _shed_lane(self, lane: Lane) -> None:
        """Mid-generation deadline miss: keep the partial output but mark
        the request shed (no finish_t: it never met its SLO)."""

        self.batcher.retire(lane)
        self.results[lane.request.id] = RequestResult(
            id=lane.request.id, status=STATUS_SHED_DEADLINE,
            tokens=list(lane.tokens), submit_t=lane.request.submit_t,
            admitted_t=lane.admitted_t, resolved_t=self._clock(),
            first_token_t=lane.first_token_t, slot=lane.slot,
            trace_id=lane.request.trace_id,
        )

    def _fallback(self, lane: Lane) -> None:
        """Nonfinite logits in the batched path: retire the lane and replay
        the request through the serial dense-cache reference."""

        self.batcher.retire(lane)
        req = lane.request
        prompt = np.asarray(req.payload["prompt"], np.int64)
        pg = self.cfg.page_size
        cache_len = pg * math.ceil((prompt.size + lane.target_new) / pg)
        try:
            toks = greedy_generate(
                self.batcher.model, self.batcher.params,
                torch.as_tensor(prompt[None]), lane.target_new, cache_len,
                dtype=self.batcher.dtype)
            self._record(req, STATUS_FALLBACK, [int(t) for t in toks[0]],
                         lane.admitted_t, "nonfinite logits in batched path",
                         slot=lane.slot, first_token_t=lane.first_token_t)
        except Exception as e:  # degradation must not take the loop down
            self._record(req, STATUS_ERROR, lane.tokens, lane.admitted_t,
                         f"serial fallback failed: {e!r}",
                         slot=lane.slot, first_token_t=lane.first_token_t)

    def _admit_one(self, req: Request, now: float) -> None:
        try:
            lane = self.batcher.admit(req, now)
        except PagedCacheError as e:
            if self.batcher.live_lanes():
                self._stalled = req  # retry once pages/slots free up
            else:
                self._record(req, STATUS_REJECTED, [], None, str(e))
            return
        except ValueError as e:
            self._record(req, STATUS_REJECTED, [], None, str(e))
            return
        lane.first_token_t = self._clock()  # prefill produced token 0
        if self.batcher.lane_done(lane):  # max_new_tokens == 1
            self._finalize(lane, STATUS_OK)

    def _admissions(self, now: float) -> None:
        if self._stalled is not None and self.batcher.can_admit():
            req, self._stalled = self._stalled, None
            self._admit_one(req, now)
        while self.batcher.can_admit() and self._stalled is None:
            got = self.queue.pop(1, now)
            if not got:
                break
            self._admit_one(got[0], now)

    def run(self) -> ServeStats:
        """Drive until the queue and all lanes drain. Deterministic: no
        threads; the overlap of host and device comes from CUDA's
        asynchronous launches."""

        pending = None
        while True:
            now = self._clock()
            self._resolve_shed()
            for lane in self.batcher.live_lanes():
                if lane.request.expired(now):
                    self._shed_lane(lane)
            self._admissions(now)  # host + prefill work overlapping `pending`
            if pending is not None:
                for lane, _tok, ok in self.batcher.harvest(pending):
                    if not ok:
                        self._fallback(lane)
                    elif self.batcher.lane_done(lane):
                        self._finalize(lane, STATUS_OK)
                pending = None
            live = self.batcher.live_lanes()
            if live:
                pending = self.batcher.dispatch()
            if not live and len(self.queue) == 0 and self._stalled is None:
                break
        self._resolve_shed()
        return self.stats()

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> ServeStats:
        res = list(self.results.values())
        ok = [r for r in res if r.status in OK_STATUSES]
        lat = [r.latency_s for r in ok if r.latency_s is not None]
        qwait = [r.queue_s for r in ok if r.queue_s is not None]
        ttft = [r.ttft_s for r in ok if r.ttft_s is not None]
        tpot = [r.tpot_s for r in ok if r.tpot_s is not None]
        qps = 0.0
        if ok:
            span = max(r.finish_t for r in ok) - min(r.submit_t for r in ok)
            qps = len(ok) / span if span > 0 else float("inf")
        return ServeStats(
            completed=len(ok),
            fallbacks=sum(r.status == STATUS_FALLBACK for r in res),
            shed_overflow=sum(r.status == STATUS_SHED_OVERFLOW for r in res),
            shed_deadline=sum(r.status == STATUS_SHED_DEADLINE for r in res),
            rejected=sum(r.status == STATUS_REJECTED for r in res),
            errors=sum(r.status == STATUS_ERROR for r in res),
            steps=self.batcher.steps_dispatched,
            qps=qps,
            latency=LatencyStats.from_samples(lat),
            queue_wait=LatencyStats.from_samples(qwait),
            ttft=LatencyStats.from_samples(ttft),
            tpot=LatencyStats.from_samples(tpot),
            lanes=self.batcher.lane_stats(),
            memory=self.batcher.memory_stats(),
        )
