"""``python -m repro_torch.obs.report run.jsonl``: render a run summary;
the port's copy of ``src/repro/obs/report.py`` (one log gives both
packages the same summary and text).

Reads an event log written by a JsonlSink (``--obs-log`` on the launch
CLIs; either package's), replays the health monitors over it, and prints:

* the run header (who/when/how many events of each kind),
* per-phase span times (spans recorded during a CUDA-graph capture, and
  the JAX package's jit-trace-time spans, reported separately),
* the metric trajectory (first/last step scalars),
* loss-scale and skip history (every backoff/growth + gated update),
* serving SLO numbers when serve events are present,
* kernel dispatch decisions keyed by (kernel, backend, reason),
* health verdicts per monitor plus the fired alerts.

``--json`` emits the same summary machine-readable; ``--validate``
exits non-zero if any line fails schema validation; ``--postmortem``
reads a flight-recorder bundle instead (``--validate`` checks it).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter as TallyCounter
from typing import Any, Dict, List, Optional

from .events import Event, read_jsonl_stats, validate_jsonl
from .health import replay
from .trace import PHASES

#: serve-plane terminal event names (the executor's TERMINAL_EVENT
#: values) — every trace ends in exactly one of these
TERMINAL_NAMES = ("done", "deadline_miss", "shed", "rejected", "error")

#: non-terminal lifecycle stages in canonical order
STAGE_NAMES = ("enqueued", "admitted", "prefill_start", "first_token", "token")


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def _pct_dict(samples: List[float]) -> Optional[Dict[str, float]]:
    """{p50,p90,p99,n} over raw samples (sorted-index percentiles, same
    convention as the tick percentiles below); None when empty."""

    if not samples:
        return None
    s = sorted(samples)

    def at(q: float) -> float:
        return s[min(len(s) - 1, int(q * len(s)))]

    return {"p50": at(0.50), "p90": at(0.90), "p99": at(0.99),
            "n": len(s)}


# ---------------------------------------------------------------------------
# request timeline reconstruction (the tentpole's offline consumer)
# ---------------------------------------------------------------------------


def serve_timelines(events: List[Event]) -> Dict[str, List[Event]]:
    """Group the serve-plane lifecycle events by ``trace_id``, preserving
    stream order — one entry per request that ever touched the queue."""

    out: Dict[str, List[Event]] = {}
    for e in events:
        if e.kind != "serve":
            continue
        tid = e.data.get("trace_id")
        if tid is None:
            continue
        out.setdefault(tid, []).append(e)
    return out


def validate_timelines(events: List[Event]) -> List[str]:
    """End-to-end timeline checks over a serve event stream ([] = every
    request's lifecycle reconstructs). Per trace_id:

    * the first event is ``enqueued`` (minted at queue.submit);
    * timestamps are monotone non-decreasing;
    * exactly ONE terminal event, and it is the last event;
    * the stages present appear in canonical order (first occurrences;
      repeats are allowed — a stalled admission retries its
      admitted/prefill_start pair).

    A score-API trace (enqueued → done, no decode stages) passes: order
    is only enforced over the stages that are present.
    """

    errors: List[str] = []
    for tid, evs in serve_timelines(events).items():
        names = [e.name for e in evs]
        short = tid[:8]
        if names[0] != "enqueued":
            errors.append(f"{short}: first event is {names[0]!r}, "
                          "expected 'enqueued'")
        ts = [e.t for e in evs]
        if any(b < a for a, b in zip(ts, ts[1:])):
            errors.append(f"{short}: timestamps not monotone")
        terminals = [n for n in names if n in TERMINAL_NAMES]
        if len(terminals) != 1:
            errors.append(f"{short}: {len(terminals)} terminal events "
                          f"({terminals}), expected exactly 1")
        elif names[-1] not in TERMINAL_NAMES:
            errors.append(f"{short}: last event is {names[-1]!r}, "
                          "expected the terminal")
        firsts = {n: names.index(n) for n in STAGE_NAMES if n in names}
        order = [firsts[n] for n in STAGE_NAMES if n in firsts]
        if order != sorted(order):
            errors.append(f"{short}: stages out of order: "
                          + " -> ".join(n for n in names))
    return errors


def _span_table(events: List[Event], traced: bool) -> List[Dict[str, Any]]:
    agg: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for e in events:
        if e.kind != "span" or bool(e.data.get("traced")) != traced:
            continue
        name = e.name
        if name not in agg:
            order.append(name)
            agg[name] = {"name": name, "n": 0, "total_us": 0.0, "max_us": 0.0}
        a = agg[name]
        dur = float(e.data.get("dur_us", 0.0))
        a["n"] += 1
        a["total_us"] += dur
        a["max_us"] = max(a["max_us"], dur)
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["n"]

    def _rank(name: str):
        try:
            return (0, PHASES.index(name))
        except ValueError:
            return (1, order.index(name))

    return [agg[n] for n in sorted(agg, key=_rank)]


def summarize(events: List[Event],
              io: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Machine-readable run summary (the ``--json`` payload). ``io``
    (the stats of ``read_jsonl_stats``) surfaces skipped log lines."""

    kinds = TallyCounter(e.kind for e in events)
    t = [e.t for e in events]
    summary: Dict[str, Any] = {
        "events": len(events),
        "kinds": dict(sorted(kinds.items())),
        "t_start": min(t) if t else None,
        "t_end": max(t) if t else None,
    }

    run_meta = [e for e in events if e.kind == "run"]
    if run_meta:
        summary["run"] = {e.name: e.data for e in run_meta}

    # log-integrity accounting: torn/invalid lines skipped at read time
    # plus ring-buffer evictions the producer reported at run_end
    run_end = next((e for e in reversed(events)
                    if e.kind == "run" and e.name == "run_end"), None)
    summary["io"] = {
        "torn_lines": int((io or {}).get("torn_lines", 0)),
        "invalid_lines": int((io or {}).get("invalid_lines", 0)),
        "ring_dropped": int(run_end.data.get("ring_dropped", 0))
        if run_end is not None else 0,
    }

    summary["phases"] = _span_table(events, traced=False)
    summary["phases_trace_time"] = _span_table(events, traced=True)

    steps = [e for e in events if e.kind == "metrics" and e.name == "step"]
    if steps:
        summary["steps"] = {
            "n": len(steps),
            "first": {"step": steps[0].step, **steps[0].data},
            "last": {"step": steps[-1].step, **steps[-1].data},
        }

    scale_events = [e for e in events if e.kind == "scale"]
    gate_events = [e for e in events
                   if e.kind == "gate" and not e.data.get("finite", True)]
    summary["scale_history"] = [
        {"step": e.step, "event": e.name, "scale": e.data.get("scale"),
         "prev": e.data.get("prev")} for e in scale_events]
    summary["skip_history"] = [
        {"step": e.step, "gate": e.name, "reason": e.data.get("reason")}
        for e in gate_events]

    serve_events = [e for e in events if e.kind == "serve"]
    serve_term = TallyCounter(
        e.name for e in serve_events
        if e.name in ("done", "deadline_miss", "shed"))
    ticks = [e for e in serve_events if e.name == "tick"]
    if serve_term or ticks:
        tick_us = sorted(float(e.data["dur_us"]) for e in ticks
                         if "dur_us" in e.data)

        def _pct(q: float) -> Optional[float]:
            if not tick_us:
                return None
            i = min(len(tick_us) - 1, int(q * len(tick_us)))
            return tick_us[i]

        terminals = [e for e in serve_events if e.name in TERMINAL_NAMES]
        summary["serve"] = {
            "terminal": dict(sorted(serve_term.items())),
            "ticks": len(ticks),
            "tick_p50_us": _pct(0.50),
            "tick_p99_us": _pct(0.99),
            "max_queue_depth": max(
                (e.data.get("queue_depth", 0) for e in ticks), default=0),
            # request-latency splits derived from the terminal events'
            # embedded metrics (no cross-event joins needed offline)
            "ttft_us": _pct_dict([float(e.data["ttft_us"])
                                  for e in terminals if "ttft_us" in e.data]),
            "tpot_us": _pct_dict([float(e.data["tpot_us"])
                                  for e in terminals if "tpot_us" in e.data]),
            "queue_wait_us": _pct_dict(
                [float(e.data["queue_wait_us"])
                 for e in terminals if "queue_wait_us" in e.data]),
            "resident_us": _pct_dict(
                [float(e.data["resident_us"])
                 for e in terminals if "resident_us" in e.data]),
        }
        lane_ev = next((e for e in reversed(serve_events)
                        if e.name == "lane_stats"), None)
        if lane_ev is not None:
            summary["serve"]["lanes"] = lane_ev.data.get("lanes")
        timelines = serve_timelines(events)
        if timelines:
            summary["serve"]["traces"] = len(timelines)
            summary["serve"]["trace_errors"] = validate_timelines(events)

    dispatch = TallyCounter(
        (e.data.get("kernel", e.name), e.data.get("backend", "?"),
         e.data.get("reason", "?"))
        for e in events if e.kind == "dispatch")
    if dispatch:
        summary["dispatch"] = [
            {"kernel": k, "backend": b, "reason": r, "n": n}
            for (k, b, r), n in sorted(dispatch.items())]

    census = [e for e in events if e.kind == "census"]
    if census:
        last = census[-1]
        summary["census"] = {"observed": last.data.get("observed"),
                             "expected": last.data.get("expected"),
                             "ok": last.data.get("ok")}

    health = replay(events)
    summary["health"] = health.summary()
    # replaying re-derives alerts; drop the duplicate alert events' echo
    summary["health"]["alerts"] = [a.as_dict() for a in health.alerts]
    return summary


def render(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`summarize`'s output."""

    lines: List[str] = []
    add = lines.append

    add("== repro_torch.obs run report ==")
    dur = None
    if summary.get("t_start") is not None and summary.get("t_end") is not None:
        dur = summary["t_end"] - summary["t_start"]
    add(f"events: {summary['events']}"
        + (f"  wall: {dur:.1f}s" if dur is not None else ""))
    add("kinds:  " + ", ".join(f"{k}={n}" for k, n in summary["kinds"].items()))
    io = summary.get("io") or {}
    if any(io.values()):
        add("io:     " + ", ".join(f"{k}={v}" for k, v in io.items())
            + "  (log loss — lines skipped or ring-evicted)")

    for key, title in (("phases", "phase spans (runtime)"),
                       ("phases_trace_time", "phase spans (jit trace time)")):
        rows = summary.get(key) or []
        if not rows:
            continue
        add("")
        add(f"-- {title} --")
        add(f"{'phase':<18} {'n':>5} {'mean':>10} {'max':>10} {'total':>10}")
        for r in rows:
            add(f"{r['name']:<18} {r['n']:>5} {_fmt_us(r['mean_us']):>10} "
                f"{_fmt_us(r['max_us']):>10} {_fmt_us(r['total_us']):>10}")

    steps = summary.get("steps")
    if steps:
        add("")
        add(f"-- metrics ({steps['n']} logged steps) --")
        for label in ("first", "last"):
            row = steps[label]
            scalars = ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "step")
            add(f"{label:<6} step {row.get('step')}: {scalars}")

    scale_hist = summary.get("scale_history") or []
    skip_hist = summary.get("skip_history") or []
    if scale_hist or skip_hist:
        add("")
        add("-- loss-scale / skip history --")
        for r in scale_hist:
            add(f"step {r['step']}: loss scale {r['event']} "
                f"{r['prev']} -> {r['scale']}")
        for r in skip_hist:
            add(f"step {r['step']}: {r['gate']} skipped ({r['reason']})")
        if not scale_hist:
            add("(no loss-scale transitions)")
    elif any(k in summary["kinds"] for k in ("metrics",)):
        add("")
        add("-- loss-scale / skip history --")
        add("(no transitions, no skips)")

    serve = summary.get("serve")
    if serve:
        add("")
        add("-- serve --")
        term = ", ".join(f"{k}={n}" for k, n in serve["terminal"].items()) or "none"
        add(f"requests: {term}")
        if serve["ticks"]:
            p50 = serve.get("tick_p50_us")
            p99 = serve.get("tick_p99_us")
            add(f"ticks: {serve['ticks']}  tick p50 "
                f"{_fmt_us(p50) if p50 is not None else '-'}  p99 "
                f"{_fmt_us(p99) if p99 is not None else '-'}  "
                f"max queue depth {serve['max_queue_depth']}")
        lat_rows = [(label, serve.get(key))
                    for label, key in (("ttft", "ttft_us"),
                                       ("tpot", "tpot_us"),
                                       ("queue wait", "queue_wait_us"),
                                       ("resident", "resident_us"))
                    if serve.get(key)]
        if lat_rows:
            add(f"{'latency':<12} {'n':>5} {'p50':>10} {'p90':>10} {'p99':>10}")
            for label, d in lat_rows:
                add(f"{label:<12} {d['n']:>5} {_fmt_us(d['p50']):>10} "
                    f"{_fmt_us(d['p90']):>10} {_fmt_us(d['p99']):>10}")
        lanes = serve.get("lanes")
        if lanes:
            add(f"{'lane':<6} {'useful':>8} {'trash':>8} {'tokens':>8} "
                f"{'goodput':>9}")
            for r in lanes:
                gp = f"{r['goodput']:.0%}" if r.get("goodput") is not None else "-"
                add(f"{r['slot']:<6} {r['useful_ticks']:>8} "
                    f"{r['trash_ticks']:>8} {r['tokens']:>8} {gp:>9}")
        if serve.get("traces"):
            errs = serve.get("trace_errors") or []
            mark = "OK" if not errs else f"{len(errs)} BROKEN"
            add(f"traces: {serve['traces']} request timelines ({mark})")
            for msg in errs[:10]:
                add(f"  broken timeline: {msg}")

    dispatch = summary.get("dispatch")
    if dispatch:
        add("")
        add("-- kernel dispatch --")
        for r in dispatch:
            add(f"{r['kernel']:<24} {r['backend']:<18} {r['reason']:<24} "
                f"x{r['n']}")

    census = summary.get("census")
    if census:
        add("")
        add("-- collective census --")
        mark = "OK" if census.get("ok") else "MISMATCH"
        add(f"all-reduces: {census.get('observed')} "
            f"(expected {census.get('expected')}) {mark}")

    health = summary["health"]
    add("")
    add(f"-- health: {health['status'].upper()} --")
    for name, v in health["monitors"].items():
        add(f"{name:<12} {v['status']:<9} {v.get('detail', '')}")
    alerts = health.get("alerts") or []
    if alerts:
        add("")
        add(f"alerts ({len(alerts)}):")
        for a in alerts:
            step = f" step {a['step']}" if a.get("step") is not None else ""
            add(f"  [{a['severity']}] {a['monitor']}{step}: {a['message']}")
    return "\n".join(lines)


def render_postmortem(bundle: Dict[str, Any], tail: int = 25) -> str:
    """Human-readable rendering of a flight-recorder postmortem bundle
    (``repro_torch.obs.flight.FlightRecorder.dump``)."""

    lines: List[str] = []
    add = lines.append
    trig = bundle.get("trigger") or {}
    add("== repro_torch.obs postmortem ==")
    add(f"trigger: {trig.get('reason', '?')}  {trig.get('detail', '')}".rstrip())
    events = [Event.from_dict(d) for d in bundle.get("events", [])]
    add(f"events: {len(events)} in ring"
        + (f"  (+{bundle.get('dropped', 0)} evicted)"
           if bundle.get("dropped") else ""))

    if events:
        t_end = events[-1].t
        add("")
        add(f"-- last {min(tail, len(events))} events (t relative to "
            "trigger) --")
        for e in events[-tail:]:
            tid = e.data.get("trace_id")
            label = f"  trace={tid[:8]}" if isinstance(tid, str) else ""
            add(f"{e.t - t_end:+9.3f}s  {e.kind}/{e.name}{label}")
        errs = validate_timelines(events)
        open_traces = sum(
            1 for evs in serve_timelines(events).values()
            if not any(ev.name in TERMINAL_NAMES for ev in evs))
        add("")
        add(f"traces in ring: {len(serve_timelines(events))} "
            f"({open_traces} still open — the likely hang suspects)")
        # a ring is a window: truncated head timelines are expected, so
        # timeline errors here are context, not verdicts
        for msg in errs[:5]:
            add(f"  note: {msg}")

    snaps = bundle.get("metrics_snapshots") or []
    if snaps:
        add("")
        add(f"-- metric snapshots ({len(snaps)}) --")
        for s in snaps[-5:]:
            kv = ", ".join(f"{k}={v}" for k, v in s.items() if k != "t")
            add(f"t={s.get('t', 0):.3f}: {kv}")

    state = bundle.get("state") or {}
    if state:
        add("")
        add("-- live state at dump --")
        for name, v in state.items():
            add(f"{name}: {json.dumps(v, default=str)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs JSONL event log.")
    parser.add_argument("log", help="path to the JSONL event log (or a "
                                    "postmortem bundle with --postmortem)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable summary instead")
    parser.add_argument("--validate", action="store_true",
                        help="fail (exit 1) if any line violates the schema")
    parser.add_argument("--diff", default=None, metavar="BASELINE",
                        help="also print a per-phase cost diff against a "
                             "baseline log (repro_torch.obs.diff)")
    parser.add_argument("--postmortem", action="store_true",
                        help="treat LOG as a flight-recorder postmortem "
                             "bundle (repro_torch.obs.flight) instead of a JSONL "
                             "stream")
    args = parser.parse_args(argv)

    if args.postmortem:
        from . import flight as flight_mod
        try:
            bundle = flight_mod.load_bundle(args.log)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{args.log}: cannot read bundle: {e}", file=sys.stderr)
            return 1
        if args.validate:
            errors = flight_mod.validate_bundle(bundle)
            if errors:
                for e in errors:
                    print(f"{args.log}: {e}", file=sys.stderr)
                return 1
        if args.json:
            print(json.dumps(bundle, indent=2, default=str))
        else:
            print(render_postmortem(bundle))
        return 0

    if args.validate:
        errors = validate_jsonl(args.log)
        if errors:
            for e in errors:
                print(f"{args.log}: {e}", file=sys.stderr)
            return 1

    events, io = read_jsonl_stats(args.log)
    if not events:
        print(f"{args.log}: no valid events", file=sys.stderr)
        return 1
    summary = summarize(events, io=io)
    if args.diff:
        from . import diff as diff_mod
        rows = diff_mod.diff_paths(args.diff, args.log)
        summary["diff"] = {"baseline": args.diff, "unit": diff_mod.UNIT,
                           "phases": [r.as_dict() for r in rows]}
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(render(summary))
        if args.diff:
            print()
            print(diff_mod.render_diff(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
