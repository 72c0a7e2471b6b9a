"""Phase-level regression diff between two runs, the port's copy of
``src/repro/obs/diff.py`` over event streams:

    PYTHONPATH=src python -m repro_torch.obs.diff BASELINE CURRENT \
        [--fail-over PCT] [--json]

Each side is a JSONL event stream (``--obs-log`` output of either
package): per-phase cost = mean runtime-span µs, and a serving stream adds
the ``serve:*`` pseudo-phases (mean TTFT, TPOT, queue wait and resident
µs over its terminal request events); or a BENCH file, a PerfRecord or a
bare attribution section (``obs.profile``): per-phase cost = the measured
``wall_us``, else the attributed FLOPs. Two sides of different units are
refused.

Output: a ranked table of per-phase deltas (worst absolute regression
first) and a one-line verdict naming the top regressor. ``--fail-over
PCT`` exits non-zero when the top regressor grew by more than PCT%. Also
callable from the report CLI: ``python -m repro_torch.obs.report run.jsonl
--diff other.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from .events import read_jsonl

#: the unit of an event stream's costs (an attribution without wall times
#: gives "flops")
UNIT = "us"


@dataclasses.dataclass
class PhaseDelta:
    phase: str
    baseline: Optional[float]
    current: Optional[float]
    delta: float          # current - baseline (0-filled for one-sided phases)
    ratio: Optional[float]  # current / baseline; None when baseline is 0/absent

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: serve terminal-event metric -> pseudo-phase name; the serve latency
#: splits diff exactly like engine phases (same µs unit)
SERVE_METRIC_PHASES = (
    ("ttft_us", "serve:ttft"),
    ("tpot_us", "serve:tpot"),
    ("queue_wait_us", "serve:queue_wait"),
    ("resident_us", "serve:resident"),
)

_SERVE_TERMINALS = ("done", "deadline_miss", "shed", "rejected", "error")


def phase_costs_from_events(events) -> Dict[str, float]:
    """Mean runtime-span µs per phase name (mean, not total, so streams of
    different lengths compare), plus the ``serve:*`` pseudo-phases of a
    serving stream."""

    total: Dict[str, float] = {}
    n: Dict[str, int] = {}
    for e in events:
        if e.kind == "serve" and e.name in _SERVE_TERMINALS:
            for key, phase in SERVE_METRIC_PHASES:
                v = e.data.get(key)
                if v is not None:
                    total[phase] = total.get(phase, 0.0) + float(v)
                    n[phase] = n.get(phase, 0) + 1
            continue
        if e.kind != "span" or e.data.get("traced"):
            continue
        total[e.name] = total.get(e.name, 0.0) + float(e.data.get("dur_us", 0.0))
        n[e.name] = n.get(e.name, 0) + 1
    return {name: total[name] / n[name] for name in total}


def phase_costs_from_bench(payload: Dict[str, Any]) -> Tuple[Dict[str, float], str]:
    """Per-phase cost summed over a BENCH payload's (or single record's)
    ``attribution`` sections: the measured ``wall_us`` where any record
    carries it, else the attributed FLOPs. Returns (costs, unit)."""

    records = payload.get("records", [payload])
    attrs = [r["attribution"] for r in records if r.get("attribution")]
    if not attrs and payload.get("phases"):
        attrs = [payload]  # a bare attribution dict
    walls: Dict[str, float] = {}
    flops: Dict[str, float] = {}
    for attr in attrs:
        for ph, b in (attr.get("phases") or {}).items():
            if b.get("wall_us") is not None:
                walls[ph] = walls.get(ph, 0.0) + float(b["wall_us"])
            flops[ph] = flops.get(ph, 0.0) + float(b.get("flops", 0.0))
    if walls:
        return walls, "us"
    return flops, "flops"


def load_phase_costs(path: str) -> Tuple[Dict[str, float], str]:
    """Sniff ``path`` (a JSONL event stream, or one JSON record, BENCH file
    or attribution) and return (per-phase costs, unit)."""

    if not path.endswith(".jsonl"):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            payload = None  # several JSON lines: an event stream
        if isinstance(payload, dict) and payload.get("kind") is None:
            return phase_costs_from_bench(payload)
    return phase_costs_from_events(read_jsonl(path)), UNIT


def diff_costs(baseline: Dict[str, float],
               current: Dict[str, float]) -> List[PhaseDelta]:
    """Ranked per-phase deltas, worst absolute regression first."""

    rows: List[PhaseDelta] = []
    for ph in sorted(set(baseline) | set(current)):
        b = baseline.get(ph)
        c = current.get(ph)
        delta = (c or 0.0) - (b or 0.0)
        ratio = (c / b) if (b and c is not None) else None
        rows.append(PhaseDelta(phase=ph, baseline=b, current=c,
                               delta=delta, ratio=ratio))
    rows.sort(key=lambda r: -r.delta)
    return rows


def top_regressor(rows: List[PhaseDelta]) -> Optional[PhaseDelta]:
    worst = next(iter(rows), None)
    return worst if worst is not None and worst.delta > 0 else None


def _fmt(v: Optional[float], unit: str = UNIT) -> str:
    if v is None:
        return "-"
    if unit != "us":
        return f"{v:.3e}"
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.1f}ms"
    return f"{v:.0f}us"


def render_diff(rows: List[PhaseDelta], unit: str = UNIT) -> str:
    lines: List[str] = []
    add = lines.append
    add("== phase diff (baseline -> current) ==")
    add(f"{'phase':<18} {'baseline':>12} {'current':>12} {'delta':>12} {'ratio':>8}")
    for r in rows:
        ratio = f"{r.ratio:.2f}x" if r.ratio is not None else "-"
        sign = "+" if r.delta > 0 else ("-" if r.delta < 0 else "")
        add(f"{r.phase:<18} {_fmt(r.baseline, unit):>12} "
            f"{_fmt(r.current, unit):>12} {sign + _fmt(abs(r.delta), unit):>12} "
            f"{ratio:>8}")
    worst = top_regressor(rows)
    add("")
    if worst is None:
        add("verdict: no phase regressed")
    else:
        pct = (f" (+{(worst.ratio - 1) * 100:.0f}%)"
               if worst.ratio is not None else " (new phase)")
        add(f"verdict: top regressor is {worst.phase}{pct}, "
            f"+{_fmt(worst.delta, unit)}")
    return "\n".join(lines)


def diff_paths_unit(baseline_path: str, current_path: str
                    ) -> Tuple[List[PhaseDelta], str]:
    """The ranked deltas of two files of one unit, and that unit; files of
    two units (one side wall times, the other FLOPs only) are refused."""
    base, base_unit = load_phase_costs(baseline_path)
    cur, cur_unit = load_phase_costs(current_path)
    if base_unit != cur_unit:
        raise ValueError(
            f"cannot diff {base_unit} ({baseline_path}) against "
            f"{cur_unit} ({current_path}): one side has measured wall "
            "times, the other only FLOPs")
    if not base and not cur:
        raise ValueError("no per-phase costs found on either side "
                         "(no spans, no serve terminal events, no attribution sections)")
    return diff_costs(base, cur), base_unit


def diff_paths(baseline_path: str, current_path: str) -> List[PhaseDelta]:
    """:func:`diff_paths_unit`'s rows."""
    return diff_paths_unit(baseline_path, current_path)[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.diff",
        description="Rank phase-level deltas between two runs.")
    ap.add_argument("baseline", help="JSONL event stream or BENCH/record/attribution JSON")
    ap.add_argument("current", help="same kind of file as baseline")
    ap.add_argument("--fail-over", type=float, default=None, metavar="PCT",
                    help="exit 1 when the top regressor grew more than PCT%%")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable rows instead of the table")
    args = ap.parse_args(argv)

    try:
        rows, unit = diff_paths_unit(args.baseline, args.current)
    except (ValueError, FileNotFoundError) as e:
        print(f"obs.diff: ERROR {e}")
        return 2
    if args.json:
        worst = top_regressor(rows)
        print(json.dumps({
            "unit": unit,
            "phases": [r.as_dict() for r in rows],
            "top_regressor": worst.as_dict() if worst else None,
        }, indent=2))
    else:
        print(render_diff(rows, unit))
    if args.fail_over is not None:
        worst = top_regressor(rows)
        if worst is not None and worst.ratio is not None \
                and (worst.ratio - 1) * 100 > args.fail_over:
            print(f"obs.diff: FAIL {worst.phase} regressed "
                  f"{(worst.ratio - 1) * 100:.1f}% > {args.fail_over}%")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
