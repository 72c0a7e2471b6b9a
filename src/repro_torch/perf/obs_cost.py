"""What observability costs a run, counted from the run itself.

Obs is host work only: no kernel and no sync point is added with it (a
step launches the same kernels with obs on or off, which ``chip_smoke.py``
and the tests hold), so on the port's host-bound training and serving
paths what it costs the wall is the host time of its own calls. Two walls
cannot show that at 3%: on the card's shared hosts the median walls of
5-step bert-base arms with obs and without differ by -8% to +8% from run
to run, while obs costs ~0.1% (PERF.md §6), so the ratio of an obs-on
arm's wall to an obs-off arm's is noise at that scale. What obs costs is
counted instead:

* **replay**: every obs call that an obs-on arm made is made again, with
  the arm's own arguments (its events, its steps' metric rows, its spans,
  its routing counts, the serving instruments' updates), on a fresh
  pipeline of the arm's configuration, and timed against the same calls
  on the arm's off configuration. The fresh pipeline must end with the
  arm's events and metric counts, which is checked: the replay leaves no
  call out. The configurations are timed by turns, the order rotated each
  round, and the cost is the median round's difference;
* **A/A**: each round also times the off configuration a second time;
  the difference of the two off timings says what the replay can
  resolve, and is reported beside the cost as a share of the arm's wall;
* **collector**: obs's objects that outlive the run (the ring's events,
  the tracer's spans) bring the next full collection nearer. CPython
  collects the oldest generation once the objects promoted since the last
  full collection exceed a quarter of those it kept, so each costs
  ``4 × full_s / kept``, with ``full_s`` a full collection timed here on
  this process's heap. Every object that the fresh pipeline holds at the
  end is counted as promoted.

``ratio = 1 + (replay + collector) / wall``, with ``wall`` the off arm's
median wall. The arms run whole, in pairs whose order alternates
(:func:`paired_arms`); their walls are reported beside the count, with
the collections that ran in each (:class:`GcMeter`), but do not decide
it.
Used by ``perf/bench_obs.py``, ``perf/bench_serve.py`` and
``chip_smoke.py`` phase 23.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

#: replay rounds; each times every configuration once
ROUNDS = 21
#: obs costs at most 3% of the wall (the JAX package's bound)
LIMIT = 1.03


class GcMeter:
    """The cyclic collector's passes while the meter is active, by
    generation: how many ran and the milliseconds they took. The collector
    runs as it does in production; the meter only listens
    (``gc.callbacks``)."""

    def __init__(self):
        self.counts = [0, 0, 0]
        self.ms = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def _callback(self, phase: str, info: Dict[str, Any]) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.counts[g] += 1
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self) -> "GcMeter":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)

    def as_dict(self) -> Dict[str, Any]:
        return {"collections": list(self.counts), "ms": list(self.ms)}


def timed_rounds(fns: Dict[str, Callable[[], Any]], rounds: int) -> Dict[str, List[float]]:
    """Seconds of each of ``fns`` over ``rounds`` rounds; a round calls
    every one once, its order rotated by one each round. One untimed round
    goes first (first calls build caches)."""

    names = list(fns)
    for n in names:
        fns[n]()
    out: Dict[str, List[float]] = {n: [] for n in names}
    for r in range(rounds):
        k = r % len(names)
        for n in names[k:] + names[:k]:
            t0 = time.perf_counter()
            fns[n]()
            out[n].append(time.perf_counter() - t0)
    return out


def paired_arms(arms: Dict[str, Callable[[], Any]], pairs: int,
                sync: Optional[Callable[[], None]] = None):
    """Whole arms in ``pairs`` pairs, the order alternating (A B, B A, ...):
    each arm's walls in seconds (``sync`` run before each reading), a
    :class:`GcMeter` of each arm's collections, and each pair's results
    ``{name: arm()}``."""

    names = list(arms)
    walls: Dict[str, List[float]] = {n: [] for n in names}
    meters = {n: GcMeter() for n in names}
    results = []
    for p in range(pairs):
        out = {}
        for n in (names if p % 2 == 0 else names[::-1]):
            with meters[n]:
                t0 = time.perf_counter()
                out[n] = arms[n]()
                if sync is not None:
                    sync()
                walls[n].append(time.perf_counter() - t0)
        results.append(out)
    return walls, meters, results


def _held(fn: Callable[[], Any]) -> int:
    """Tracked objects that ``fn``'s result keeps alive."""

    gc.collect(1)
    n0 = len(gc.get_objects())
    kept = fn()
    gc.collect(1)
    n1 = len(gc.get_objects())
    del kept
    return n1 - n0


def collector_seconds_per_object() -> Dict[str, float]:
    """One full collection of this process's heap, timed, and what each
    object promoted into the oldest generation costs on average: a full
    collection runs once the promoted objects exceed a quarter of those
    the last one kept."""

    gc.collect()
    t0 = time.perf_counter()
    gc.collect()
    full_s = time.perf_counter() - t0
    kept = len(gc.get_objects(generation=2))
    return {"full_ms": full_s * 1e3, "kept_objects": kept,
            "s_per_object": 4.0 * full_s / max(kept, 1)}


def counted(on: Callable[[], Any], off: Callable[[], Any], wall_s: float, *,
            rounds: int = ROUNDS, collector: Optional[Dict[str, float]] = None
            ) -> Dict[str, Any]:
    """What ``on`` costs over ``off`` (two replays of one arm's obs calls,
    each returning what it keeps alive) against ``wall_s``, the off arm's
    wall; see the module docstring."""

    t = timed_rounds({"on": on, "off": off, "off_again": off}, rounds)
    on_s, off_s, again_s = (np.asarray(t[k]) for k in ("on", "off", "off_again"))
    replay_s = float(np.median(on_s - off_s))
    aa = again_s - off_s
    retained = max(_held(on) - _held(off), 0)
    collector = collector or collector_seconds_per_object()
    collector_s = retained * collector["s_per_object"]
    cost_s = replay_s + collector_s
    return {"ratio": 1.0 + cost_s / wall_s, "limit": LIMIT, "cost_ms": cost_s * 1e3,
            "replay_ms": replay_s * 1e3, "collector_ms": collector_s * 1e3,
            "retained_objects": retained, "wall_ms": wall_s * 1e3, "rounds": rounds,
            "aa_median_share": float(np.median(aa)) / wall_s,
            "aa_max_share": float(np.max(np.abs(aa))) / wall_s,
            "collector": collector}


def signature(o) -> Dict[str, Any]:
    """What a pipeline received, to check a replay against its arm: the
    events by (kind, name), each counter's values and each histogram's
    count (gauges by name: a replay sets them to the arm's values)."""

    events = collections.Counter((e.kind, e.name) for e in o.sink.events())
    metrics = {}
    for name, snap in o.metrics.snapshot().items():
        if snap["kind"] == "counter":
            metrics[name] = snap["values"]
        elif snap["kind"] == "histogram":
            metrics[name] = snap["n"]
        else:
            metrics[name] = "gauge"
    return {"events": dict(events), "metrics": metrics}


def _check(name: str, got: Dict[str, Any], want: Dict[str, Any]) -> None:
    if got != want:
        raise AssertionError(f"{name}: the replay does not remake the arm's obs calls: "
                             f"{got} != {want}")


# ---------------------------------------------------------------------------
# training: run_loop's observe_step, the routing mirror, the phase spans
# ---------------------------------------------------------------------------


def _dispatch_calls(o) -> List[tuple]:
    """(kernel, backend, reason, calls) from a pipeline's dispatch_total."""

    counter = o.metrics.get("dispatch_total")
    if counter is None:
        return []
    return [(v["labels"]["kernel"], v["labels"]["backend"], v["labels"]["reason"],
             int(v["value"])) for v in counter.snapshot()["values"]]


def train_replay(arm_obs, events: Sequence, make_obs: Callable[[], Any], *,
                 spans_under_tracer: bool = False):
    """The ``(on, off)`` replays of a training arm: ``arm_obs`` is the arm's
    pipeline (its routing counts), ``events`` what its sink received,
    ``make_obs`` builds a fresh pipeline of its configuration. With
    ``spans_under_tracer`` the arm's steps ran under an activated tracer
    of its pipeline, whose ``span`` events are remade as spans."""

    from repro_torch import obs as obs_mod
    from repro_torch.obs import trace

    routes = _dispatch_calls(arm_obs)
    rows = [(e.step, e.data) for e in events if e.kind == "metrics" and e.name == "step"]
    spans = [e.name for e in events if e.kind == "span"]
    # remade by observe_step, observe_dispatch, the tracer and the monitors
    derived = {"metrics", "scale", "gate", "dispatch", "span", "alert"}
    rest = [e for e in events if e.kind not in derived]

    def replay(o):
        for kernel, backend, reason, n in routes:
            for _ in range(n):
                if o.enabled:  # kernels/dispatch.route's guard
                    o.observe_dispatch(kernel, backend, reason)
        if spans:
            tracer = obs_mod.Tracer(obs=o) if o.enabled and spans_under_tracer else None
            with obs_mod.activate(tracer) if tracer is not None else contextlib.nullcontext():
                for name in spans:
                    with trace.phase(name):
                        pass
        for step, row in rows:
            if o.enabled:  # run_loop's guard
                o.observe_step(step, row)
        for e in rest:
            o.emit(e.kind, e.name, data=e.data, step=e.step)
        return o

    def on():
        o = replay(make_obs())
        o.close()
        return o

    def off():
        return replay(obs_mod.NULL_OBS)

    return on, off


def train_cost(arm_obs, events: Sequence, make_obs: Callable[[], Any], wall_s: float, *,
               spans_under_tracer: bool = False, read_back: Optional[Callable] = None,
               rounds: int = ROUNDS, collector=None) -> Dict[str, Any]:
    """:func:`counted` over a training arm's replay, after checking that a
    fresh pipeline ends with the arm's events and routing counts.
    ``read_back(o)`` gives a closed pipeline's events where its sink keeps
    none in memory (a JSONL file)."""

    on, off = train_replay(arm_obs, events, make_obs, spans_under_tracer=spans_under_tracer)
    o = on()
    got = collections.Counter((e.kind, e.name) for e in
                              (read_back(o) if read_back else o.sink.events()))
    want = collections.Counter((e.kind, e.name) for e in events)
    _check("train", {"events": dict(got), "routes": sorted(_dispatch_calls(o))},
           {"events": dict(want), "routes": sorted(_dispatch_calls(arm_obs))})
    return counted(on, off, wall_s, rounds=rounds, collector=collector)


# ---------------------------------------------------------------------------
# serving: the executor's and the queue's events, instruments and ring
# ---------------------------------------------------------------------------


def serve_replay(events: Sequence, make_obs: Optional[Callable[[], Any]],
                 flight_capacity: int, snapshot_every: int = 16):
    """One replay of a served run's obs calls (``events``: what the traced
    arm's sink received): ``make_obs`` builds the traced pipeline (None:
    untraced), ``flight_capacity`` sizes the always-on ring (0: none).
    Mirrors ``serve/executor.py`` and ``serve/queue.py``: the data dict
    built at the call site, the instruments updated for ticks, terminals
    and sheds, the event teed into the pipeline and the ring, a ring
    snapshot every ``snapshot_every`` ticks."""

    from repro_torch import obs as obs_mod
    from repro_torch.obs import flight as flight_mod
    from repro_torch.obs.report import TERMINAL_NAMES

    todo = [e for e in events if e.kind != "alert"]  # the monitors remake them

    def replay():
        o = make_obs() if make_obs is not None else obs_mod.NULL_OBS
        fr = flight_mod.FlightRecorder(flight_capacity) if flight_capacity else None
        if fr is not None:
            fr.attach(o)
        if not o.enabled and fr is None:  # the executor builds nothing
            return o, fr
        if o.enabled:
            hist_request = o.histogram("serve_request_us")
            hist_tick = o.histogram("serve_tick_us")
            ctr_requests = o.counter("serve_requests")
            gauge_lanes = o.gauge("serve_active_lanes")
            gauge_depth = o.gauge("serve_queue_depth")
        ticks = 0
        for e in todo:
            data = dict(e.data)
            if o.enabled:
                if e.name == "tick":
                    hist_tick.observe(data["dur_us"])
                    gauge_lanes.set(data["active_lanes"])
                    gauge_depth.set(data["queue_depth"])
                elif e.name in TERMINAL_NAMES:
                    if "resident_us" in data:
                        hist_request.observe(data["resident_us"])
                    ctr_requests.inc(labels={"status": data["status"]})
                elif e.name == "queue_shed":
                    o.counter("queue_sheds").inc(labels={"reason": data["reason"]})
            flight_mod.emit_teed(o, fr, e.kind, e.name, data=data, step=e.step)
            if fr is not None and e.name == "tick":
                ticks += 1
                if ticks % snapshot_every == 0:
                    fr.record_snapshot({"tick": ticks, "queue_depth": data["queue_depth"],
                                        "active_lanes": data["active_lanes"], "steps": ticks})
        return o, fr

    return replay


def serve_cost(arm_obs, arm_flight, make_obs: Callable[[], Any], wall_s: float, *,
               flight_capacity: int, snapshot_every: int = 16, rounds: int = ROUNDS,
               collector=None) -> Dict[str, Any]:
    """What tracing costs a served run over the untraced executor
    (``traced``), and what the always-on flight ring costs the untraced
    one over none (``flight``), each by :func:`counted` against
    ``wall_s``. ``arm_obs`` and ``arm_flight`` are the traced arm's
    pipeline and ring: a fresh replay must end with their events, metric
    counts and ring length."""

    traced = serve_replay(arm_obs.sink.events(), make_obs, flight_capacity, snapshot_every)
    untraced = serve_replay(arm_obs.sink.events(), None, flight_capacity, snapshot_every)
    bare = serve_replay(arm_obs.sink.events(), None, 0)
    o, fr = traced()
    _check("serve", {"obs": signature(o), "ring": len(fr.events()) if fr else 0},
           {"obs": signature(arm_obs), "ring": len(arm_flight.events()) if arm_flight else 0})
    collector = collector or collector_seconds_per_object()
    return {"traced": counted(traced, untraced, wall_s, rounds=rounds, collector=collector),
            "flight": counted(untraced, bare, wall_s, rounds=rounds, collector=collector)}
