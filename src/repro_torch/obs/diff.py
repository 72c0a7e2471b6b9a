"""Phase-level regression diff between two runs, the port's copy of
``src/repro/obs/diff.py`` over event streams:

    PYTHONPATH=src python -m repro_torch.obs.diff BASELINE CURRENT \
        [--fail-over PCT] [--json]

Each side is a JSONL event stream (``--obs-log`` output of either
package): per-phase cost = mean runtime-span µs, and a serving stream adds
the ``serve:*`` pseudo-phases (mean TTFT, TPOT, queue wait and resident
µs over its terminal request events). The JAX package also diffs BENCH
records by their ``attribution`` sections (FLOPs parsed from XLA's HLO);
the port's records carry none (ROADMAP queue 1 item 11).

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
from typing import Any, Dict, List, Optional

from .events import read_jsonl

#: the unit of every cost here (the JAX package's diff also knows "flops")
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


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.1f}ms"
    return f"{v:.0f}us"


def render_diff(rows: List[PhaseDelta]) -> str:
    lines: List[str] = []
    add = lines.append
    add("== phase diff (baseline -> current) ==")
    add(f"{'phase':<18} {'baseline':>12} {'current':>12} {'delta':>12} {'ratio':>8}")
    for r in rows:
        ratio = f"{r.ratio:.2f}x" if r.ratio is not None else "-"
        sign = "+" if r.delta > 0 else ("-" if r.delta < 0 else "")
        add(f"{r.phase:<18} {_fmt(r.baseline):>12} "
            f"{_fmt(r.current):>12} {sign + _fmt(abs(r.delta)):>12} "
            f"{ratio:>8}")
    worst = top_regressor(rows)
    add("")
    if worst is None:
        add("verdict: no phase regressed")
    else:
        pct = (f" (+{(worst.ratio - 1) * 100:.0f}%)"
               if worst.ratio is not None else " (new phase)")
        add(f"verdict: top regressor is {worst.phase}{pct}, "
            f"+{_fmt(worst.delta)}")
    return "\n".join(lines)


def diff_paths(baseline_path: str, current_path: str) -> List[PhaseDelta]:
    base = phase_costs_from_events(read_jsonl(baseline_path))
    cur = phase_costs_from_events(read_jsonl(current_path))
    if not base and not cur:
        raise ValueError("no per-phase costs found on either side "
                         "(no runtime spans, no serve terminal events)")
    return diff_costs(base, cur)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.diff",
        description="Rank phase-level deltas between two runs' event logs.")
    ap.add_argument("baseline", help="JSONL event stream")
    ap.add_argument("current", help="JSONL event stream")
    ap.add_argument("--fail-over", type=float, default=None, metavar="PCT",
                    help="exit 1 when the top regressor grew more than PCT%%")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable rows instead of the table")
    args = ap.parse_args(argv)

    try:
        rows = diff_paths(args.baseline, args.current)
    except (ValueError, FileNotFoundError) as e:
        print(f"obs.diff: ERROR {e}")
        return 2
    if args.json:
        worst = top_regressor(rows)
        print(json.dumps({
            "unit": UNIT,
            "phases": [r.as_dict() for r in rows],
            "top_regressor": worst.as_dict() if worst else None,
        }, indent=2))
    else:
        print(render_diff(rows))
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
