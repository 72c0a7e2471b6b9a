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

Every request's lifecycle is an event stream (``repro_torch.obs``):
``enqueued`` (the queue), ``admitted``, ``prefill_start``,
``first_token``, one ``token`` per harvested token, and exactly one
terminal event (:attr:`ServeExecutor.TERMINAL_EVENT`) carrying the
derived splits ``queue_wait_us``, ``ttft_us``, ``tpot_us`` and
``resident_us``; each tick emits a ``tick`` event, the run a
``lane_stats`` one. They go into the obs pipeline when it is enabled and
into the always-on flight recorder (``ServeConfig.flight_capacity``),
whose postmortem bundle a degraded health alert, an exception out of the
loop, or the hang watchdog (``ServeConfig.hang_deadline_s``) dumps. Under
an activated ``obs.Tracer`` each tick is a ``serve_tick`` span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import NULL_OBS
from repro_torch.obs import flight as flight_mod
from repro_torch.obs import trace as trace_mod
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

    #: terminal status -> serve-event name (the health monitors' SLO
    #: vocabulary: "done"/"deadline_miss"/"shed" count toward the miss
    #: rate; "rejected"/"error" are bugs or impossibilities, not load)
    TERMINAL_EVENT = {
        STATUS_OK: "done",
        STATUS_FALLBACK: "done",
        STATUS_SHED_DEADLINE: "deadline_miss",
        STATUS_SHED_OVERFLOW: "shed",
        STATUS_REJECTED: "rejected",
        STATUS_ERROR: "error",
    }

    def __init__(self, model, params, cfg: Optional[ServeConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic, obs=None):
        cfg = cfg or ServeConfig()
        self.cfg = cfg
        obs = obs if obs is not None else NULL_OBS
        self._obs = obs
        # the recorder's providers and the watchdog hold the executor
        # weakly: a cycle through them would keep its paged cache on the
        # card until a full collection
        me = weakref.ref(self)
        # the always-on flight recorder (flight_capacity=0 opts out): the
        # ring keeps the recent events in memory even with no obs pipeline,
        # so a postmortem never depends on the run having an --obs-log
        self.flight: Optional[flight_mod.FlightRecorder] = None
        if cfg.flight_capacity > 0:
            self.flight = flight_mod.FlightRecorder(cfg.flight_capacity,
                                                    out_dir=cfg.flight_dir)
            self.flight.attach(obs)  # a degraded health alert dumps
            self.flight.add_state_provider("queue", lambda: me()._queue_state())
            self.flight.add_state_provider("lanes", lambda: me()._lane_state())
            self.flight.add_state_provider("memory", lambda: me()._memory_state())
        self._watchdog: Optional[flight_mod.HangWatchdog] = None
        if cfg.hang_deadline_s is not None:
            self._watchdog = flight_mod.HangWatchdog(cfg.hang_deadline_s,
                                                     lambda stall: me()._on_hang(stall))
        self.batcher = ContinuousBatcher(model, params, cfg)  # rejects encoders
        self.queue = RequestQueue(cfg.queue_depth,
                                  default_timeout_s=cfg.default_timeout_s,
                                  clock=clock, obs=obs, flight=self.flight)
        self._clock = clock
        self.results: Dict[int, RequestResult] = {}
        self._stalled: Optional[Request] = None
        self._inject_hang: Optional[tuple] = None  # (at_step, seconds)
        # instrument handles, hoisted out of the loop (each registry access
        # is a lock and a dict lookup)
        if obs.enabled:
            self._hist_request = obs.histogram("serve_request_us")
            self._hist_tick = obs.histogram("serve_tick_us")
            self._ctr_requests = obs.counter("serve_requests")
            self._gauge_lanes = obs.gauge("serve_active_lanes")
            self._gauge_depth = obs.gauge("serve_queue_depth")

    # -- flight-recorder plumbing -------------------------------------------

    def _queue_state(self) -> Dict[str, Any]:
        return dataclasses.asdict(self.queue.stats())

    def _lane_state(self) -> List[Dict[str, Any]]:
        return [{"slot": ln.slot, "trace_id": ln.request.trace_id,
                 "request_id": ln.request.id, "prompt_len": ln.prompt_len,
                 "tokens": len(ln.tokens), "target_new": ln.target_new}
                for ln in self.batcher.live_lanes()]

    def _memory_state(self) -> Dict[str, Any]:
        """The paged cache's accounting (host numbers) and, on the card,
        the caching allocator's count of allocated bytes: a read that is
        safe from the watchdog's thread and waits for nothing."""

        out = self.batcher.memory_stats()
        if self.batcher.device.type == "cuda":
            out["device_allocated_bytes"] = torch.cuda.memory_allocated(self.batcher.device)
        return out

    def _on_hang(self, stall_s: float) -> None:
        """Watchdog trigger: runs on the watchdog's thread while the tick
        loop is stuck, so it only reads."""

        if self.flight is not None:
            self.flight.dump(
                flight_mod.REASON_HANG,
                detail=f"no tick progress for {stall_s:.2f}s "
                       f"(deadline {self.cfg.hang_deadline_s}s)")

    def _emit(self, name: str, data: Dict[str, Any],
              step: Optional[int] = None) -> None:
        """One serve-plane lifecycle event, into the obs pipeline (when
        enabled) and the flight ring (when present)."""

        flight_mod.emit_teed(self._obs, self.flight, "serve", name, data=data, step=step)

    def _observe_terminal(self, result: RequestResult) -> None:
        if not self._obs.enabled and self.flight is None:
            return
        name = self.TERMINAL_EVENT.get(result.status, result.status)
        data: Dict[str, Any] = {"request_id": result.id,
                                "trace_id": result.trace_id,
                                "status": result.status,
                                "tokens": len(result.tokens)}
        if result.slot is not None:
            data["slot"] = result.slot
        if result.latency_s is not None:
            data["latency_us"] = result.latency_s * 1e6
        # the resident time exists for every terminal status, sheds
        # included, so SLO percentiles see the worst outcomes too
        if result.resident_s is not None:
            data["resident_us"] = result.resident_s * 1e6
        if result.queue_s is not None:
            data["queue_wait_us"] = result.queue_s * 1e6
        if result.ttft_s is not None:
            data["ttft_us"] = result.ttft_s * 1e6
        if result.tpot_s is not None:
            data["tpot_us"] = result.tpot_s * 1e6
        if self._obs.enabled:
            if result.resident_s is not None:
                self._hist_request.observe(result.resident_s * 1e6)
            self._ctr_requests.inc(labels={"status": result.status})
        self._emit(name, data)

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
        self._observe_terminal(self.results[req.id])

    def _resolve_shed(self) -> None:
        for ev in self.queue.drain_shed():
            self.results[ev.request.id] = RequestResult(
                id=ev.request.id, status=ev.reason, tokens=[],
                submit_t=ev.request.submit_t, resolved_t=ev.t,
                trace_id=ev.request.trace_id,
            )
            self._observe_terminal(self.results[ev.request.id])

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
        self._observe_terminal(self.results[lane.request.id])

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
                dtype=self.batcher.dtype, prefill_mode=self.cfg.prefill_mode)
            self._record(req, STATUS_FALLBACK, [int(t) for t in toks[0]],
                         lane.admitted_t, "nonfinite logits in batched path",
                         slot=lane.slot, first_token_t=lane.first_token_t)
        except Exception as e:  # degradation must not take the loop down
            self._record(req, STATUS_ERROR, lane.tokens, lane.admitted_t,
                         f"serial fallback failed: {e!r}",
                         slot=lane.slot, first_token_t=lane.first_token_t)

    def _admit_one(self, req: Request, now: float) -> None:
        trace = self._obs.enabled or self.flight is not None
        if trace:
            # "admitted" precedes batcher.admit (the slot is known only once
            # prefill allocates one: it rides on first_token); a stalled
            # admission retried later repeats both stage events, which
            # timeline validation allows
            self._emit("admitted", {
                "trace_id": req.trace_id, "request_id": req.id,
                "queue_wait_us": (now - req.submit_t) * 1e6})
            self._emit("prefill_start", {
                "trace_id": req.trace_id, "request_id": req.id,
                "prompt_len": int(np.asarray(req.payload["prompt"]).size)})
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
        if trace:
            self._emit("first_token", {
                "trace_id": req.trace_id, "request_id": req.id, "slot": lane.slot,
                "ttft_us": (lane.first_token_t - req.submit_t) * 1e6})
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

    def inject_hang(self, seconds: float, at_step: int = 1) -> None:
        """Fault injection: stall the tick loop for ``seconds`` (a host
        sleep) just before harvesting decode step ``at_step``; with
        ``hang_deadline_s`` below it the watchdog must notice and dump a
        postmortem."""

        self._inject_hang = (at_step, seconds)

    def run(self) -> ServeStats:
        """Drive until the queue and all lanes drain. Deterministic: the
        optional hang watchdog's thread only reads; the overlap of host and
        device comes from CUDA's asynchronous launches."""

        if self._watchdog is not None:
            self._watchdog.beat()
            self._watchdog.start()
        try:
            return self._run()
        except Exception as e:
            if self.flight is not None:  # an unhandled loop failure dumps
                self.flight.dump(flight_mod.REASON_EXCEPTION, detail=repr(e))
            raise
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()

    def _run(self) -> ServeStats:
        pending = None
        observe = self._obs.enabled or self.flight is not None  # hoisted
        tracer = trace_mod.active_tracer()  # hoisted: one contextvar read
        watchdog = self._watchdog
        tick_n = 0
        snapshot_every = max(1, self.cfg.flight_snapshot_every)
        while True:
            # under an activated tracer each tick is one span of the chrome
            # trace; without one, nullcontext costs nothing per tick
            span = tracer.span("serve_tick") if tracer is not None else contextlib.nullcontext()
            with span:
                tick_t0 = time.perf_counter() if observe else 0.0
                now = self._clock()
                self._resolve_shed()
                for lane in self.batcher.live_lanes():
                    if lane.request.expired(now):
                        self._shed_lane(lane)
                self._admissions(now)  # host + prefill work overlapping `pending`
                if self._inject_hang is not None \
                        and self.batcher.steps_dispatched >= self._inject_hang[0]:
                    seconds, self._inject_hang = self._inject_hang[1], None
                    time.sleep(seconds)
                if pending is not None:
                    step_n = self.batcher.steps_dispatched
                    for lane, _tok, ok in self.batcher.harvest(pending):
                        if observe and ok:
                            self._emit("token", {
                                "trace_id": lane.request.trace_id,
                                "slot": lane.slot, "n": len(lane.tokens)}, step=step_n)
                        if not ok:
                            self._fallback(lane)
                        elif self.batcher.lane_done(lane):
                            self._finalize(lane, STATUS_OK)
                    pending = None
                live = self.batcher.live_lanes()
                if live:
                    pending = self.batcher.dispatch()
                if observe:
                    self._observe_tick(tick_t0, len(live))
                tick_n += 1
                if self.flight is not None and tick_n % snapshot_every == 0:
                    self.flight.record_snapshot({
                        "tick": tick_n, "queue_depth": len(self.queue),
                        "active_lanes": len(live),
                        "steps": self.batcher.steps_dispatched})
                if watchdog is not None:
                    watchdog.beat()  # a completed tick is progress
            if not live and len(self.queue) == 0 and self._stalled is None:
                break
        self._resolve_shed()
        if observe:
            self._emit("lane_stats", {"lanes": self.batcher.lane_stats(),
                                      "steps": self.batcher.steps_dispatched})
        return self.stats()

    def _observe_tick(self, tick_t0: float, active_lanes: int) -> None:
        """Per-tick telemetry: the tick latency histogram, lane and
        queue-depth gauges (obs only), and the ``tick`` event the
        queue-depth monitor reads (obs and the flight ring)."""

        dur_us = (time.perf_counter() - tick_t0) * 1e6
        depth = len(self.queue)
        if self._obs.enabled:
            self._hist_tick.observe(dur_us)
            self._gauge_lanes.set(active_lanes)
            self._gauge_depth.set(depth)
        self._emit("tick", data={
            "dur_us": dur_us, "active_lanes": active_lanes, "lanes": self.cfg.slots,
            "queue_depth": depth, "capacity": self.queue.max_depth,
        })

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
