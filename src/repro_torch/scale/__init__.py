"""repro_torch.scale: microbatch accumulation, mixed-precision policies and
the memory planner for the SAMA step, after ``src/repro/scale``:

* ``policy``: PrecisionPolicy (f32 master parameters; bf16, or f16 under a
  dynamic loss scale, compute; f32 accumulation) and ScaleConfig, the
  knob on ``EngineConfig`` and everything above it (``MetaLearner``, the
  data optimizer's meta scorer, ``launch.train``);
* ``accum``: microbatch accumulation for the base unroll and the
  hypergradient stage;
* ``plan``: ``plan_microbatch``, the smallest microbatch count whose step
  fits a device-memory budget, measured on the card
  (``torch.cuda.max_memory_allocated``; an estimate on the CPU).

    from repro_torch import scale
    learner = MetaLearner(spec, unroll_steps=2,
                          scale=scale.ScaleConfig(policy="bf16", microbatch=4))
    plan = scale.plan_microbatch(spec, base_opt, meta_opt, cfg, state,
                                 base_batches, meta_batch, hbm_budget=40 * 2**30)
"""

from repro_torch.scale.accum import (
    accumulate_mean,
    microbatch_local_terms,
    microbatch_value_and_grad,
    split_batch,
)
from repro_torch.scale.policy import (
    POLICIES,
    LossScaleState,
    PrecisionPolicy,
    ScaleConfig,
    all_finite,
    apply_to_spec,
    backoff_on,
    cast_floats,
    init_scale_state,
    resolve_policy,
    select_tree,
    update_scale,
)

#: the planner resolves lazily: policy and accum are primitives of the core
#: (core.engine imports this package), while plan.py imports the engine and
#: repro_torch.perf
_PLAN_EXPORTS = ("AVAL_ACTIVATION_MULTIPLIER", "ExecPlan", "candidate_microbatches",
                 "measure_peak", "plan_microbatch")


def __getattr__(name):
    if name in _PLAN_EXPORTS:
        from repro_torch.scale import plan

        return getattr(plan, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AVAL_ACTIVATION_MULTIPLIER", "ExecPlan", "LossScaleState", "POLICIES",
    "PrecisionPolicy", "ScaleConfig", "accumulate_mean", "all_finite",
    "apply_to_spec", "backoff_on", "candidate_microbatches", "cast_floats",
    "init_scale_state", "measure_peak", "microbatch_local_terms",
    "microbatch_value_and_grad", "plan_microbatch", "resolve_policy",
    "select_tree", "split_batch", "update_scale",
]
