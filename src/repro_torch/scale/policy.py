"""Mixed-precision policies for the SAMA hot path, after
``src/repro/scale/policy.py``.

A ``PrecisionPolicy`` names three dtypes and, optionally, a dynamic loss
scale:

* ``param_dtype``: the master copy of the base parameters. ``EngineState``
  keeps theta, and so the optimizer moments derived from it, in this
  dtype: f32 in every built-in policy.
* ``compute_dtype``: the dtype the loss and its backward pass run in.
  ``apply_to_spec`` installs the cast boundary: theta's and the batch's
  float leaves are cast to ``compute_dtype`` on the way into the spec's
  losses, and the loss comes back f32. The cast is recorded by autograd,
  so its backward casts the low-precision gradients up again: gradients
  with respect to the master parameters arrive in ``param_dtype``. The
  same wrapped spec feeds the base unroll and the hypergradient passes.
  The model's activations stay in its config's ``dtype``, as in the JAX
  package: the policy casts the parameters and the batch, not the model.
* ``accum_dtype``: the dtype of microbatch accumulators
  (``repro_torch.scale.accum``); f32 in every built-in policy.

``loss_scale > 0`` turns on dynamic loss scaling (the f16 policy): the
base loss is multiplied by the live scale before its backward pass, the
gradient is unscaled after accumulation, and a non-finite unscaled
gradient skips that base update (parameters and optimizer state keep
their values) and halves the scale; after ``growth_interval``
consecutive finite steps the scale doubles. bf16 has f32's exponent range
and runs unscaled.

Every gate stays on the device: the automaton's state is a pair of 0-d
tensors, and each choice is a ``torch.where`` on a 0-d bool tensor, so a
step never waits for the device (``run_loop`` reads the metrics only at
its log cadence). lam, the meta parameters, keeps its own dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch import tree as tu

Tree = Any


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32`` (the policies store names)."""

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype triple and loss-scale knobs. Dtypes are stored by name, so
    the policy is hashable and JSON-able."""

    name: str = "f32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    # 0.0 = no loss scaling; > 0 = the initial dynamic scale
    loss_scale: float = 0.0
    growth_interval: int = 200
    max_loss_scale: float = float(2 ** 24)
    min_loss_scale: float = 1.0

    @property
    def param_torch(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def compute_torch(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def accum_torch(self) -> torch.dtype:
        return torch_dtype(self.accum_dtype)

    @property
    def dynamic_scaling(self) -> bool:
        return self.loss_scale > 0.0

    @property
    def is_identity(self) -> bool:
        """The policy changes nothing (the f32 default): callers skip the
        spec wrapper, so the paper-exact path stays untouched."""
        return (self.compute_torch == torch.float32 and self.param_torch == torch.float32
                and not self.dynamic_scaling)


#: the built-in policies: f32 master parameters everywhere; bf16 computes
#: unscaled, f16 under a dynamic loss scale with skip-on-nonfinite. The f16
#: scale starts at and is capped at 2^15: the backward seed is the scale
#: itself cast through the f16 boundary, and float16(2^16) is inf, so growth
#: past the cap would skip a base step every growth_interval whatever the
#: model.
POLICIES = {
    "f32": PrecisionPolicy(name="f32"),
    "bf16": PrecisionPolicy(name="bf16", compute_dtype="bfloat16"),
    "f16": PrecisionPolicy(name="f16", compute_dtype="float16", loss_scale=float(2 ** 15),
                           max_loss_scale=float(2 ** 15)),
}


def resolve_policy(policy: Union[str, PrecisionPolicy]) -> PrecisionPolicy:
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        if policy not in POLICIES:
            raise ValueError(f"unknown precision policy {policy!r}; built-ins: {sorted(POLICIES)}")
        return POLICIES[policy]
    raise TypeError(f"policy must be a name or PrecisionPolicy, got {type(policy).__name__}")


def cast_floats(tree: Tree, dtype: torch.dtype) -> Tree:
    """The floating-point leaves of ``tree`` cast to ``dtype``; integer and
    bool leaves (token ids, labels) pass through untouched."""

    def one(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tu.tree_map(one, tree)


def apply_to_spec(spec, policy: PrecisionPolicy):
    """The policy's cast boundary on a BilevelSpec: theta's and the batch's
    float leaves go down to ``compute_dtype`` on entry, the scalar loss
    comes back f32 (aux, when present, passes through). lam is not cast.
    The identity policy returns ``spec`` itself."""

    # core.engine imports this module, so BilevelSpec resolves here
    from repro_torch.core.bilevel import BilevelSpec

    if policy.is_identity:
        return spec
    cdt = policy.compute_torch

    def wrap(loss_fn):
        def wrapped(theta, lam, batch):
            out = loss_fn(cast_floats(theta, cdt), lam, cast_floats(batch, cdt))
            if spec.has_aux:
                return out[0].to(torch.float32), out[1]
            return out.to(torch.float32)

        return wrapped

    return BilevelSpec(base_loss=wrap(spec.base_loss), meta_loss=wrap(spec.meta_loss),
                       has_aux=spec.has_aux)


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------


class LossScaleState(NamedTuple):
    """Carried in ``EngineState.scale`` when the policy scales losses."""

    scale: torch.Tensor  # 0-d f32, the live multiplier
    good_steps: torch.Tensor  # 0-d int32, consecutive finite base steps


def init_scale_state(policy: PrecisionPolicy, *, device="cpu") -> Optional[LossScaleState]:
    """The initial LossScaleState on ``device``; None when the policy does
    not scale (the EngineState field then adds no leaves)."""

    if not policy.dynamic_scaling:
        return None
    return LossScaleState(scale=torch.tensor(policy.loss_scale, dtype=torch.float32,
                                             device=device),
                          good_steps=torch.zeros((), dtype=torch.int32, device=device))


def all_finite(tree: Tree) -> torch.Tensor:
    """0-d bool tensor: every float leaf of ``tree`` is finite."""

    leaves = [x for x in tu.flatten_with_keys(tree)[1]
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    out = torch.isfinite(leaves[0]).all()
    for x in leaves[1:]:
        out = torch.logical_and(out, torch.isfinite(x).all())
    return out


def update_scale(state: LossScaleState, finite: torch.Tensor,
                 policy: PrecisionPolicy) -> LossScaleState:
    """The dynamic loss-scale automaton: halve on a non-finite step (and
    reset the streak), double after ``growth_interval`` consecutive finite
    steps, clamped to [min_loss_scale, max_loss_scale]."""

    zero = torch.zeros_like(state.good_steps)
    good = torch.where(finite, state.good_steps + 1, zero)
    grow = torch.logical_and(finite, good >= policy.growth_interval)
    scale = torch.where(finite, torch.where(grow, state.scale * 2.0, state.scale),
                        state.scale * 0.5)
    scale = torch.clamp(scale, policy.min_loss_scale, policy.max_loss_scale)
    good = torch.where(grow, zero, good)
    return LossScaleState(scale=scale.to(torch.float32), good_steps=good.to(torch.int32))


def backoff_on(state: LossScaleState, finite: torch.Tensor,
               policy: PrecisionPolicy) -> LossScaleState:
    """Backoff only: halve the scale and reset the streak when ``finite`` is
    False, the identity otherwise. For events that must never grow the
    scale (the hypergradient path's finiteness: streaks count base steps
    only)."""

    halved = torch.clamp(state.scale * 0.5, policy.min_loss_scale, policy.max_loss_scale)
    scale = torch.where(finite, state.scale, halved)
    good = torch.where(finite, state.good_steps, torch.zeros_like(state.good_steps))
    return LossScaleState(scale=scale.to(torch.float32), good_steps=good.to(torch.int32))


def select_tree(pred: torch.Tensor, on_true: Tree, on_false: Tree, *, out: Tree = None) -> Tree:
    """Leafwise ``torch.where`` on a 0-d predicate: the skip-on-nonfinite
    gate (parameters and moments keep their old values on a skipped
    step). ``out``, one of the two trees when its buffers belong to the
    caller alone, takes the result in place, so no parameter-sized copy is
    allocated."""

    if out is None:
        return tu.tree_map(lambda t, f: torch.where(pred, t, f), on_true, on_false)
    tu.tree_map(lambda t, f, o: torch.where(pred, t, f, out=o), on_true, on_false, out)
    return out


# ---------------------------------------------------------------------------
# the user-facing config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """The scale knobs as they ride on ``EngineConfig`` (and so on
    ``MetaLearner``, the data optimizer's meta scorer and
    ``launch.train``):

    ``policy``: "f32" | "bf16" | "f16" or a PrecisionPolicy.
    ``microbatch``: M. Each base batch, and the meta and last batches the
    hypergradient stage reads, is split into M microbatches accumulated
    in a loop (``repro_torch.scale.accum``), so activation memory is
    O(batch / M). Leading batch dims must be divisible by M
    (``plan_microbatch`` proposes only divisors).
    """

    policy: Union[str, PrecisionPolicy] = "f32"
    microbatch: int = 1

    def __post_init__(self):
        resolve_policy(self.policy)  # fail at config time, not at the first step
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {self.microbatch}")

    def resolve(self) -> PrecisionPolicy:
        return resolve_policy(self.policy)

    @property
    def is_identity(self) -> bool:
        return self.microbatch == 1 and self.resolve().is_identity
