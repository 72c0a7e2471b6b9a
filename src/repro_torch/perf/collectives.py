"""The collective census of one executed step, after
``src/repro/perf/collectives.py``.

The single-sync schedule's claim, exactly ``unroll_steps`` base
all-reduces plus ONE meta bucket per meta step, is structural, so it is
audited on what ran. The JAX package parses the compiled step's HLO; the
port counts the calls themselves: every collective goes through
``launch.distributed.collective``, which a ``CollectiveCounter`` records
per kind (calls and bytes). The keys are the reference's
(``all-reduce_count``, ``all-reduce_bytes``, ... ``total_count``,
``total_bytes``); its HLO-only ones (trip-count scaling) have no
counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Union

from repro_torch.launch.distributed import COLLECTIVES, CollectiveCounter


def census(counter: CollectiveCounter) -> Dict[str, Any]:
    """Per-kind collective counts and bytes of the calls a counter saw (the
    reference's kinds; one that did not occur counts 0), with their
    totals."""

    out: Dict[str, Any] = {}
    for kind in COLLECTIVES:
        out[f"{kind}_bytes"] = int(counter.bytes.get(kind, 0))
        out[f"{kind}_count"] = int(counter.counts.get(kind, 0))
    out["total_bytes"] = sum(out[f"{k}_bytes"] for k in COLLECTIVES)
    out["total_count"] = sum(out[f"{k}_count"] for k in COLLECTIVES)
    return out


def verify_single_sync(stats: Union[CollectiveCounter, Dict[str, Any]],
                       unroll_steps: int) -> Dict[str, Any]:
    """Check the paper's single-sync invariant on one executed step: its
    all-reduce count equals ``unroll_steps`` (the per-step base reduces)
    + 1 (the one meta bucket). ``stats`` is the step's counter or its
    :func:`census`. Returns the census with ``expected_all_reduces`` and
    ``single_sync_ok``; raises nothing, callers decide what a miss means."""

    out = census(stats) if isinstance(stats, CollectiveCounter) else dict(stats)
    out["expected_all_reduces"] = unroll_steps + 1
    out["single_sync_ok"] = out["all-reduce_count"] == unroll_steps + 1
    return out
