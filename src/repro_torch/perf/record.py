"""The versioned ``PerfRecord`` schema and the ``BENCH_<name>.json`` files,
after ``src/repro/perf/record.py``: schema v1 unchanged, so a record of
either package validates in the other. Only ``env_info`` differs: it names
torch, CUDA and the card instead of jax.

One ``PerfRecord`` = one measured probe (a step function, a decode loop,
a whole bench arm): robust run timing (timers.TimingStats), throughput,
per-device memory (memory.memory_report) and, from the JAX package, the
collective census and the per-phase attribution. A bench file bundles the
bench's ``rows`` with its ``records`` plus environment provenance: the
unit the regression gate (gate.py) compares against baselines.

Writes are atomic (tmp file + ``os.replace``) so a killed bench run can
never leave a half-written JSON where the trajectory tracker reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch.perf.timers import StepMeasurement, TimingStats

SCHEMA_VERSION = 1

_TIMING_KEYS = {"median_us", "iqr_us", "min_us", "max_us", "mean_us", "repeats", "warmup"}
_LATENCY_KEYS = {"p50_us", "p90_us", "p99_us", "mean_us", "max_us", "n"}


@dataclasses.dataclass
class PerfRecord:
    """One measured performance probe. Sections are optional — a memory
    sweep has no timing, a census probe has neither — but a record with
    no section at all is invalid."""

    name: str
    us_per_step: Optional[Dict[str, Any]] = None  # TimingStats.as_dict()
    samples_per_s: Optional[float] = None
    compile_s: Optional[float] = None
    lower_s: Optional[float] = None
    memory: Optional[Dict[str, Any]] = None  # memory.memory_report()
    collectives: Optional[Dict[str, Any]] = None  # collectives.census()
    latency: Optional[Dict[str, Any]] = None  # timers.LatencyStats.as_dict()
    attribution: Optional[Dict[str, Any]] = None  # obs.profile.attribute()
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @staticmethod
    def from_measurement(name: str, m: StepMeasurement, *,
                         samples_per_step: Optional[float] = None,
                         memory: Optional[Dict[str, Any]] = None,
                         collectives: Optional[Dict[str, Any]] = None,
                         extra: Optional[Dict[str, Any]] = None) -> "PerfRecord":
        extra = dict(extra or {})
        if m.first_call_s is not None:
            extra["first_call_s"] = m.first_call_s
        return PerfRecord(
            name=name,
            us_per_step=m.timing.as_dict(),
            samples_per_s=(m.samples_per_s(samples_per_step)
                           if samples_per_step is not None else None),
            compile_s=m.compile_s,
            lower_s=m.lower_s,
            memory=memory,
            collectives=collectives,
            extra=extra,
        )

    @property
    def timing(self) -> Optional[TimingStats]:
        if self.us_per_step is None:
            return None
        return TimingStats(**{k: self.us_per_step[k] for k in _TIMING_KEYS})


def validate_attribution(d: Dict[str, Any]) -> List[str]:
    """Schema errors for one ``attribution`` section ([] = valid).

    The section is additive to schema v1 (like ``latency``): an optional
    dict produced by the JAX package's ``repro.obs.profile.attribute``:
    per-phase FLOP / bytes / collective partition of one compiled step, with
    optional measured ``wall_us`` / ``utilization`` per phase."""

    errors: List[str] = []
    if not isinstance(d, dict):
        return [f"attribution must be a dict, got {type(d).__name__}"]
    phases = d.get("phases")
    if not isinstance(phases, dict) or not phases:
        return ["attribution.phases must be a non-empty dict"]
    frac_sum = 0.0
    for name, b in phases.items():
        if not isinstance(b, dict):
            errors.append(f"attribution.phases[{name!r}] must be a dict")
            continue
        for key in ("flops", "flop_frac"):
            v = b.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                errors.append(f"attribution.phases[{name!r}].{key} must be "
                              "a non-negative number")
        frac_sum += float(b.get("flop_frac") or 0.0)
        wall = b.get("wall_us")
        if wall is not None and (not isinstance(wall, (int, float)) or wall <= 0):
            errors.append(f"attribution.phases[{name!r}].wall_us must be > 0")
    total = d.get("total")
    if not isinstance(total, dict) or "flops" not in total:
        errors.append("attribution.total must carry at least flops")
    cov = d.get("coverage")
    if not isinstance(cov, (int, float)) or not (0.0 <= cov <= 1.0 + 1e-9):
        errors.append("attribution.coverage must be a number in [0, 1]")
    total_flops = (total or {}).get("flops") or 0.0
    if total_flops > 0 and abs(frac_sum - 1.0) > 1e-3:
        errors.append(f"attribution phase flop_fracs sum to {frac_sum:.6f}, "
                      "expected ~1")
    return errors


def validate_record(d: Dict[str, Any]) -> List[str]:
    """Schema errors for one record dict ([] = valid)."""

    errors: List[str] = []
    if not isinstance(d, dict):
        return [f"record must be a dict, got {type(d).__name__}"]
    if not isinstance(d.get("name"), str) or not d.get("name"):
        errors.append("record.name must be a non-empty string")
    if d.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"record.schema_version must be {SCHEMA_VERSION}, "
                      f"got {d.get('schema_version')!r}")
    timing = d.get("us_per_step")
    if timing is not None:
        if not isinstance(timing, dict) or not _TIMING_KEYS <= set(timing):
            errors.append(f"record.us_per_step must carry {sorted(_TIMING_KEYS)}")
        elif timing["median_us"] <= 0:
            errors.append("record.us_per_step.median_us must be > 0")
    for scalar in ("samples_per_s", "compile_s", "lower_s"):
        v = d.get(scalar)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            errors.append(f"record.{scalar} must be a non-negative number")
    mem = d.get("memory")
    if mem is not None:
        per_dev = mem.get("per_device") if isinstance(mem, dict) else None
        if not isinstance(per_dev, dict) or "argument_bytes" not in per_dev \
                or "source" not in per_dev:
            errors.append("record.memory.per_device must carry at least "
                          "argument_bytes and source")
    coll = d.get("collectives")
    if coll is not None:
        if not isinstance(coll, dict) or "total_count" not in coll \
                or "all-reduce_count" not in coll:
            errors.append("record.collectives must carry per-type and total counts")
    lat = d.get("latency")
    if lat is not None:
        if not isinstance(lat, dict) or not _LATENCY_KEYS <= set(lat):
            errors.append(f"record.latency must carry {sorted(_LATENCY_KEYS)}")
        elif lat["p50_us"] <= 0 or lat["p99_us"] < lat["p50_us"]:
            errors.append("record.latency needs p50_us > 0 and p99_us >= p50_us")
    attr = d.get("attribution")
    if attr is not None:
        errors.extend(f"record {d.get('name')!r}: {e}"
                      for e in validate_attribution(attr))
    if d.get("us_per_step") is None and mem is None and coll is None \
            and lat is None and attr is None:
        errors.append(f"record {d.get('name')!r} carries no measured section "
                      "(us_per_step / memory / collectives / latency / "
                      "attribution)")
    return errors


# ---------------------------------------------------------------------------
# bench files
# ---------------------------------------------------------------------------


def env_info() -> Dict[str, Any]:
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


def bench_payload(bench: str, *, fast: bool, elapsed_s: float,
                  rows: List[Dict[str, Any]],
                  records: List[PerfRecord]) -> Dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "fast": fast,
        "elapsed_s": round(elapsed_s, 1),
        "env": env_info(),
        "rows": list(rows),
        "records": [r.as_dict() if isinstance(r, PerfRecord) else r for r in records],
    }


def validate_bench(payload: Dict[str, Any]) -> List[str]:
    errors: List[str] = []
    if payload.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"bench.schema_version must be {SCHEMA_VERSION}")
    if not isinstance(payload.get("bench"), str) or not payload.get("bench"):
        errors.append("bench.bench must be a non-empty string")
    if not isinstance(payload.get("rows"), list):
        errors.append("bench.rows must be a list")
    records = payload.get("records")
    if not isinstance(records, list):
        errors.append("bench.records must be a list")
    else:
        for rec in records:
            errors.extend(validate_record(rec))
    return errors


def write_json_atomic(path: str, payload: Dict[str, Any]) -> None:
    """Write JSON via tmp file + rename — readers never see a torn file."""

    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_bench(path: str, payload: Dict[str, Any]) -> None:
    """Validate + atomically write one BENCH_<name>.json."""

    errors = validate_bench(payload)
    if errors:
        raise ValueError(f"invalid bench payload for {path}: " + "; ".join(errors))
    write_json_atomic(path, payload)


def load_bench(path: str) -> Dict[str, Any]:
    with open(path) as f:
        payload = json.load(f)
    errors = validate_bench(payload)
    if errors:
        raise ValueError(f"invalid bench file {path}: " + "; ".join(errors))
    return payload
