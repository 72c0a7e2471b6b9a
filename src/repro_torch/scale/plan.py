"""The HBM-budget memory planner, after ``src/repro/scale/plan.py``.

``plan_microbatch`` answers: given this model and this much device memory,
how little accumulation will do? It bisects the candidate microbatch counts
(common divisors of the base and meta batches' leading dims) for the
smallest M, the largest fitting microbatch, whose step fits the budget,
measuring each candidate with :func:`measure_peak`:

* on the card (source ``"cuda_max_allocated"``): the JAX package compiles
  each candidate and reads XLA's buffer assignment without allocating;
  eager PyTorch has no such analysis, so the port runs the candidate step:
  one warm-up call, then ``torch.cuda.reset_peak_memory_stats`` and one
  measured call, and reads ``torch.cuda.max_memory_allocated``. Both calls
  step from the given state and their results are dropped: the learner's
  state does not advance. The peak includes everything else the process
  holds on the card at the time (the state itself, the batches);
* on the CPU (source ``"aval"``): the reference's fallback formula,
  argument + output bytes exactly (the output from one run of the step)
  plus a coarse activation estimate
  ``batch_bytes * AVAL_ACTIVATION_MULTIPLIER / M`` over every batch leaf.
  Its job is monotonicity in M so that the bisection converges, not
  accuracy.

An out-of-memory error at a candidate: the JAX planner never allocates,
so a candidate that does not fit is a number above the budget there. The
port's measurement allocates, and a candidate can exhaust the card before
it finishes. :func:`measure_peak` catches exactly
``torch.cuda.OutOfMemoryError`` around the candidate's calls, frees the
cache, and reports the candidate as not fitting: its peak is None, which
the search reads as above any budget. Nothing broader is caught.

The search assumes the peak is non-increasing in M (more accumulation
never costs memory); ``ExecPlan.candidates`` keeps every (M, peak) it
measured, so callers can check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.perf.memory import tree_bytes
from repro_torch.scale.policy import ScaleConfig

#: coarse activations per batch byte for the CPU estimate: transformer
#: backward passes hold O(10) activation copies of the token stream; only
#: monotonicity in M matters for the search
AVAL_ACTIVATION_MULTIPLIER = 12.0

#: how a candidate's peak was obtained
SOURCE_CUDA = "cuda_max_allocated"
SOURCE_AVAL = "aval"


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """The planner's verdict: run with ``scale`` (the input ScaleConfig
    with ``microbatch`` replaced by the chosen M)."""

    microbatch: int
    scale: ScaleConfig
    peak_bytes: Optional[int]  # measured peak of the chosen M; None: it ran out of memory
    hbm_budget: int
    fits: bool  # False: even the largest candidate M exceeds the budget
    source: str
    #: every (M, peak_bytes) the search measured, ascending in M; a peak of
    #: None ran out of memory
    candidates: Tuple[Tuple[int, Optional[int]], ...] = ()


def _batch_dims(base_batches, meta_batch) -> Tuple[int, int]:
    base_leaves = tu.flatten_with_keys(base_batches)[1]
    meta_leaves = tu.flatten_with_keys(meta_batch)[1]
    if not base_leaves or not meta_leaves:
        raise ValueError("plan_microbatch needs non-empty base and meta batches")
    return base_leaves[0].shape[1], meta_leaves[0].shape[0]  # (K, B, ...) / (B, ...)


def candidate_microbatches(base_batches, meta_batch, max_microbatch: Optional[int] = None,
                           *, shard_divisor: int = 1) -> Tuple[int, ...]:
    """Ascending Ms that divide both the per-step base batch and the meta
    batch (``split_batch`` needs exact divisibility). ``shard_divisor`` is
    the data-parallel extent of the single-sync schedule, whose
    ``split_batch`` runs on each rank's rows: the candidates divide the
    shard (global / ranks), not the global batch. 1 for the global-batch
    step and one device."""

    base_b, meta_b = _batch_dims(base_batches, meta_batch)
    if shard_divisor < 1 or base_b % shard_divisor or meta_b % shard_divisor:
        raise ValueError(f"batches (base {base_b}, meta {meta_b}) do not shard evenly over "
                         f"{shard_divisor} data-parallel devices")
    base_b //= shard_divisor
    meta_b //= shard_divisor
    ms = [m for m in range(1, min(base_b, meta_b) + 1)
          if base_b % m == 0 and meta_b % m == 0
          and (max_microbatch is None or m <= max_microbatch)]
    if not ms:
        raise ValueError(f"no common microbatch divisor for per-shard base batch {base_b} / "
                         f"meta batch {meta_b} under max_microbatch={max_microbatch}")
    return tuple(ms)


def _on_card(state) -> bool:
    leaves = tu.flatten_with_keys(state)[1]
    return bool(leaves) and leaves[0].device.type == "cuda"


def measure_peak(spec, base_opt, meta_opt, engine_cfg, state, base_batches, meta_batch, *,
                 mesh=None, schedule: str = "pjit") -> Tuple[Optional[int], str]:
    """One candidate's ``(peak_bytes, source)``. On the card: a warm-up
    call and a measured call of the step from ``state`` (not advanced),
    ``peak_bytes`` None when the candidate runs out of memory. On the CPU:
    the aval estimate (module docstring). With a ``mesh`` the step is the
    ``schedule``'s (``launch.distributed``) and every rank measures its
    own peak: each rank must call the planner."""

    from repro_torch.core.engine import make_meta_step  # engine imports this package

    if schedule == "single_sync":
        from repro_torch.launch.distributed import make_manual_step  # launch sits above

        if mesh is None:
            raise ValueError("schedule='single_sync' needs a mesh")
        step = make_manual_step(spec, base_opt, meta_opt, engine_cfg, mesh)
    elif mesh is not None:
        from repro_torch.launch.distributed import make_pjit_step

        step = make_pjit_step(spec, base_opt, meta_opt, engine_cfg, mesh)
    else:
        step = make_meta_step(spec, base_opt, meta_opt, engine_cfg)
    if not _on_card(state):
        out = step(state, base_batches, meta_batch)
        act = int(tree_bytes((base_batches, meta_batch)) * AVAL_ACTIVATION_MULTIPLIER
                  / max(engine_cfg.scale.microbatch, 1))
        return tree_bytes((state, base_batches, meta_batch)) + tree_bytes(out) + act, SOURCE_AVAL
    try:
        out = step(state, base_batches, meta_batch)  # warm-up: kernel libraries, handles
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(state, base_batches, meta_batch)
        torch.cuda.synchronize()
        del out
        return int(torch.cuda.max_memory_allocated()), SOURCE_CUDA
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, SOURCE_CUDA


def _fits(peak: Optional[int], budget: int) -> bool:
    return peak is not None and peak <= budget


def plan_microbatch(spec, base_opt, meta_opt, engine_cfg, state, base_batches, meta_batch, *,
                    hbm_budget: int, mesh=None, schedule: str = "pjit",
                    max_microbatch: Optional[int] = None) -> ExecPlan:
    """Bisect the smallest microbatch count M whose step peak fits
    ``hbm_budget`` bytes per device. Returns an ``ExecPlan`` whose
    ``scale`` is ``engine_cfg.scale`` with the chosen M: feed it back as
    ``dataclasses.replace(engine_cfg, scale=plan.scale)``. When even the
    largest candidate does not fit, ``fits`` is False and the plan carries
    that largest M. On a ``mesh`` the candidates divide each rank's rows
    (``candidate_microbatches``' ``shard_divisor``) under either
    ``schedule``: both run ``split_batch`` on the rank's rows, where JAX's
    partitioner reshards the global-batch step's microbatches."""

    if hbm_budget <= 0:
        raise ValueError(f"hbm_budget must be > 0 bytes, got {hbm_budget}")
    dp = mesh.size if mesh is not None else 1
    cands = candidate_microbatches(base_batches, meta_batch, max_microbatch, shard_divisor=dp)
    tried = {}

    def peak_of(m: int):
        if m not in tried:
            cfg_m = dataclasses.replace(
                engine_cfg, scale=dataclasses.replace(engine_cfg.scale, microbatch=m))
            tried[m] = measure_peak(spec, base_opt, meta_opt, cfg_m, state, base_batches,
                                    meta_batch, mesh=mesh, schedule=schedule)
        return tried[m][0]

    # bisect the ascending candidates: the peak is non-increasing in M, so
    # the fitting ones form a suffix; find its first element
    lo, hi = 0, len(cands) - 1
    best = None
    if _fits(peak_of(cands[hi]), hbm_budget):
        while lo < hi:
            mid = (lo + hi) // 2
            if _fits(peak_of(cands[mid]), hbm_budget):
                hi = mid
            else:
                lo = mid + 1
        best = cands[lo]

    chosen = best if best is not None else cands[-1]
    peak, source = tried[chosen]
    return ExecPlan(
        microbatch=chosen,
        scale=dataclasses.replace(engine_cfg.scale, microbatch=chosen),
        peak_bytes=peak,
        hbm_budget=int(hbm_budget),
        fits=best is not None,
        source=source,
        candidates=tuple((m, tried[m][0]) for m in sorted(tried)),
    )
