"""Measured-performance telemetry of the port, after ``src/repro/perf``:
timers, memory accounting, the versioned PerfRecord schema (v1, shared with
the JAX package) and the baseline regression gate.

    from repro_torch import perf

    rec = perf.profile_step("sama", learner.step_fn, state, bb, mb,
                            samples_per_step=batch * unroll)
    rec.as_dict()  # -> PerfRecord JSON (timing + memory)

The collective census of one executed step (``perf.collectives``: the
calls ``launch.distributed.collective`` counted) takes the place of the
reference's HLO census, and the per-phase attribution of one executed
call (``obs.profile``) the place of its HLO attribution.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tu
from repro_torch.perf.collectives import census, census_of, verify_single_sync
from repro_torch.perf.gate import GateReport, Tolerance, compare_dirs, compare_record
from repro_torch.perf.memory import MemoryStats, device_memory, memory_report, tree_bytes
from repro_torch.perf.record import (
    SCHEMA_VERSION,
    PerfRecord,
    bench_payload,
    env_info,
    load_bench,
    validate_attribution,
    validate_bench,
    validate_record,
    write_bench,
    write_json_atomic,
)
from repro_torch.perf.timers import (
    LatencyStats,
    StepMeasurement,
    TimingStats,
    compile_split,
    measure,
    synchronize,
    time_callable,
)


def profile_step(name: str, fn, *args, samples_per_step: Optional[float] = None,
                 warmup: int = 2, repeats: int = 5,
                 extra: Optional[Dict[str, Any]] = None, attribution: bool = False,
                 attribution_spans=None) -> PerfRecord:
    """The protocol on one step function, as a PerfRecord: run timing
    (``measure``'s protocol, the first call's seconds in
    ``extra["first_call_s"]``) and memory. With a CUDA tensor among
    ``args`` the peak is ``torch.cuda.max_memory_allocated`` over the timed
    calls, reset after the warmup calls (the first builds kernels and
    library workspaces); otherwise only the argument trees' bytes.

    ``attribution=True`` adds the record's ``attribution`` section: one
    more call of ``fn`` partitioned by engine phase (``obs.profile``);
    ``attribution_spans`` (measured spans, such as
    ``MetaLearner.phase_profile``'s) join per-phase wall time and
    utilization into it."""

    on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                  for x in tu.flatten_with_keys(args)[1])
    first_s = compile_split(fn, *args)[2] if warmup >= 1 else None
    for _ in range(warmup - 1):
        fn(*args)
    synchronize()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    timing = time_callable(fn, *args, warmup=0, repeats=repeats)
    m = StepMeasurement(timing=dataclasses.replace(timing, warmup=warmup),
                        first_call_s=first_s)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    mem = memory_report(example_args=args, peak_bytes=peak)
    rec = PerfRecord.from_measurement(name, m, samples_per_step=samples_per_step, memory=mem,
                                      extra=extra)
    if attribution:
        from repro_torch.obs import profile as profile_mod  # lazy: obs imports perf

        rec.attribution = profile_mod.attribute(fn, *args, spans=attribution_spans)
    return rec


__all__ = [
    "GateReport", "LatencyStats", "MemoryStats", "PerfRecord", "SCHEMA_VERSION",
    "StepMeasurement", "TimingStats", "Tolerance",
    "bench_payload", "census", "census_of", "compare_dirs", "compare_record", "compile_split",
    "device_memory", "env_info", "load_bench", "measure", "memory_report", "profile_step",
    "synchronize",
    "time_callable", "tree_bytes", "validate_attribution", "validate_bench",
    "validate_record", "verify_single_sync", "write_bench", "write_json_atomic",
]
