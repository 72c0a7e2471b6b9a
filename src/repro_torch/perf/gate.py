"""Regression gate, after ``src/repro/perf/gate.py``: measured BENCH_*.json
vs baselines, with the same bands and verdicts; the environment check
compares the torch version where the JAX gate compares jax's.

    PYTHONPATH=src python -m repro_torch.perf.gate \
        --records build/table2 --baselines DIR [--strict-missing]

Records are matched bench-file by bench-file, then record by ``name``.
Per-metric tolerance bands (regressions only — getting faster/smaller
never fails):

* ``us_per_step.median``  — ratio band, default 2.5x (CI wall time on
  shared CPU runners is noisy; the band catches order-of-magnitude
  regressions, the trajectory catches drift)
* ``samples_per_s``       — inverse ratio band (same default)
* ``latency.p50_us/p99_us`` — ratio band (same default as time: served
  tail latency on shared runners inherits the same noise floor)
* ``memory.peak_bytes``   — ratio band, default 1.15x (the caching
  allocator's peak is deterministic for a fixed step; 15% absorbs
  torch-version churn)

* ``attribution.{phase}.flops`` — ratio band, default 1.10x (the counts
  are deterministic for a fixed step; a trip names the phase whose cost
  moved)
* ``attribution.{phase}.wall_us`` — the time band

The port's records carry no collective census, so the JAX gate's bands on
that section are not here.

A record with no committed baseline is reported as NEW (pass); a
baseline whose record is missing from the run is MISSING — a pass by
default so subset CI jobs can gate what they ran, an error under
``--strict-missing`` (lost coverage should not slip through full runs).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys
from typing import Any, Dict, List, Optional

from repro_torch.perf import record as record_mod


@dataclasses.dataclass(frozen=True)
class Tolerance:
    time_ratio: float = 2.5
    throughput_ratio: float = 2.5
    memory_ratio: float = 1.15
    attribution_flops_ratio: float = 1.10


@dataclasses.dataclass(frozen=True)
class Violation:
    bench: str
    record: str
    metric: str
    baseline: float
    current: float
    limit: float

    def __str__(self) -> str:
        return (f"REGRESSION {self.bench}/{self.record}: {self.metric} "
                f"{self.current:.6g} vs baseline {self.baseline:.6g} "
                f"(limit {self.limit:.6g})")


def _peak_bytes(rec: Dict[str, Any]) -> Optional[float]:
    per_dev = (rec.get("memory") or {}).get("per_device") or {}
    peak = per_dev.get("peak_bytes")
    return float(peak) if peak is not None else None


def compare_record(bench: str, current: Dict[str, Any], baseline: Dict[str, Any],
                   tol: Tolerance) -> List[Violation]:
    """Band-compare one measured record against its committed baseline.
    Only metrics present in BOTH records participate."""

    name = current["name"]
    out: List[Violation] = []

    cur_t, base_t = current.get("us_per_step"), baseline.get("us_per_step")
    if cur_t and base_t:
        limit = base_t["median_us"] * tol.time_ratio
        if cur_t["median_us"] > limit:
            out.append(Violation(bench, name, "us_per_step.median_us",
                                 base_t["median_us"], cur_t["median_us"], limit))

    cur_s, base_s = current.get("samples_per_s"), baseline.get("samples_per_s")
    if cur_s is not None and base_s is not None and base_s > 0:
        limit = base_s / tol.throughput_ratio
        if cur_s < limit:
            out.append(Violation(bench, name, "samples_per_s", base_s, cur_s, limit))

    cur_l, base_l = current.get("latency"), baseline.get("latency")
    if cur_l and base_l:
        for key in ("p50_us", "p99_us"):  # the served-SLO pair (timers.LatencyStats)
            if key in cur_l and key in base_l:
                limit = base_l[key] * tol.time_ratio
                if cur_l[key] > limit:
                    out.append(Violation(bench, name, f"latency.{key}",
                                         base_l[key], cur_l[key], limit))

    cur_m, base_m = _peak_bytes(current), _peak_bytes(baseline)
    if cur_m is not None and base_m is not None and base_m > 0:
        limit = base_m * tol.memory_ratio
        if cur_m > limit:
            out.append(Violation(bench, name, "memory.peak_bytes", base_m, cur_m, limit))

    # per-phase attribution bands: FLOPs (tight: deterministic counts) and
    # measured wall time (the time band), naming the phase
    cur_a = (current.get("attribution") or {}).get("phases") or {}
    base_a = (baseline.get("attribution") or {}).get("phases") or {}
    for ph in sorted(set(cur_a) & set(base_a)):
        cb, bb = cur_a[ph], base_a[ph]
        base_fl = float(bb.get("flops") or 0.0)
        if base_fl > 0 and cb.get("flops") is not None:
            limit = base_fl * tol.attribution_flops_ratio
            if float(cb["flops"]) > limit:
                out.append(Violation(bench, name, f"attribution.{ph}.flops",
                                     base_fl, float(cb["flops"]), limit))
        base_w = bb.get("wall_us")
        if base_w and cb.get("wall_us") is not None:
            limit = float(base_w) * tol.time_ratio
            if float(cb["wall_us"]) > limit:
                out.append(Violation(bench, name, f"attribution.{ph}.wall_us",
                                     float(base_w), float(cb["wall_us"]), limit))
    return out


@dataclasses.dataclass
class GateReport:
    violations: List[Violation]
    compared: int
    new_records: List[str]
    #: baselined records absent from a bench that WAS re-run — lost coverage
    missing_records: List[str]
    #: baselined benches not re-run at all — expected for subset CI jobs
    missing_benches: List[str]
    #: "bench: current vs baseline torch" where env.torch_version differs:
    #: the memory bands are version-dependent
    env_mismatches: List[str] = dataclasses.field(default_factory=list)

    def ok(self, *, strict_missing: bool = False,
           strict_missing_records: bool = False) -> bool:
        """``strict_missing`` fails on ANY baselined-but-absent coverage
        (full-run mode); ``strict_missing_records`` fails only on records
        missing from benches that were re-run — the right strictness for
        subset CI jobs, where whole non-run benches are expected but a
        re-run bench silently dropping a gated record is not."""

        if self.violations:
            return False
        if strict_missing and (self.missing_records or self.missing_benches):
            return False
        if strict_missing_records and self.missing_records:
            return False
        return True


def compare_bench(current: Dict[str, Any], baseline: Dict[str, Any],
                  tol: Tolerance) -> GateReport:
    bench = current["bench"]
    cur = {r["name"]: r for r in current["records"]}
    base = {r["name"]: r for r in baseline["records"]}
    violations: List[Violation] = []
    compared = 0
    for name in sorted(set(cur) & set(base)):
        compared += 1
        violations.extend(compare_record(bench, cur[name], base[name], tol))
    cur_ver = (current.get("env") or {}).get("torch_version")
    base_ver = (baseline.get("env") or {}).get("torch_version")
    return GateReport(
        violations=violations,
        compared=compared,
        new_records=[f"{bench}/{n}" for n in sorted(set(cur) - set(base))],
        missing_records=[f"{bench}/{n}" for n in sorted(set(base) - set(cur))],
        missing_benches=[],
        env_mismatches=([f"{bench}: torch {cur_ver} vs baseline {base_ver}"]
                        if cur_ver != base_ver else []),
    )


def compare_dirs(records_dir: str, baselines_dir: str,
                 tol: Optional[Tolerance] = None) -> GateReport:
    """Gate every BENCH_*.json under ``records_dir`` against its namesake
    under ``baselines_dir``. Baselines with no run file count as missing
    benches (see --strict-missing); run files with no baseline are NEW."""

    tol = tol or Tolerance()
    total = GateReport([], 0, [], [], [])
    cur_files = {os.path.basename(p): p
                 for p in glob.glob(os.path.join(records_dir, "BENCH_*.json"))}
    base_files = {os.path.basename(p): p
                  for p in glob.glob(os.path.join(baselines_dir, "BENCH_*.json"))}
    if not cur_files:
        raise FileNotFoundError(f"no BENCH_*.json under {records_dir}")
    for fname, path in sorted(cur_files.items()):
        current = record_mod.load_bench(path)
        if fname not in base_files:
            total.new_records.append(f"{current['bench']} (whole bench)")
            continue
        report = compare_bench(current, record_mod.load_bench(base_files[fname]),
                               tol)
        total.violations.extend(report.violations)
        total.compared += report.compared
        total.new_records.extend(report.new_records)
        total.missing_records.extend(report.missing_records)
        total.env_mismatches.extend(report.env_mismatches)
    total.missing_benches = [f[len("BENCH_"):-len(".json")]
                             for f in sorted(set(base_files) - set(cur_files))]
    return total


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--records", required=True, help="dir with the run's BENCH_*.json")
    ap.add_argument("--baselines", required=True,
                    help="dir with the baseline BENCH_*.json")
    ap.add_argument("--tol-time", type=float, default=Tolerance.time_ratio)
    ap.add_argument("--tol-throughput", type=float, default=Tolerance.throughput_ratio)
    ap.add_argument("--tol-memory", type=float, default=Tolerance.memory_ratio)
    ap.add_argument("--tol-attr-flops", type=float, default=Tolerance.attribution_flops_ratio)
    ap.add_argument("--strict-missing", action="store_true",
                    help="fail when ANY baselined bench/record was not re-measured "
                         "(full-run mode)")
    ap.add_argument("--strict-missing-records", action="store_true",
                    help="fail when a RE-RUN bench silently dropped a baselined "
                         "record (subset-CI mode: whole non-run benches still pass)")
    args = ap.parse_args(argv)

    tol = Tolerance(time_ratio=args.tol_time, throughput_ratio=args.tol_throughput,
                    memory_ratio=args.tol_memory,
                    attribution_flops_ratio=args.tol_attr_flops)
    try:
        report = compare_dirs(args.records, args.baselines, tol)
    except (FileNotFoundError, ValueError) as e:
        print(f"perf-gate: ERROR {e}")
        return 2

    for v in report.violations:
        print(str(v))
    for name in report.new_records:
        print(f"NEW {name} (no baseline — commit one to start gating it)")
    for name in report.missing_records:
        print(f"MISSING record {name} (baselined but not in this run)")
    for name in report.missing_benches:
        print(f"MISSING bench {name} (baselined but not in this run)")
    for msg in report.env_mismatches:
        print(f"WARNING env mismatch {msg}: the memory bands are "
              "version-dependent; re-baseline on the new version if they trip")
    ok = report.ok(strict_missing=args.strict_missing,
                   strict_missing_records=args.strict_missing_records)
    print(f"perf-gate: {report.compared} records compared, "
          f"{len(report.violations)} regressions -> {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
