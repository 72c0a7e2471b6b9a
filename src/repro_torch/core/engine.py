"""The meta-training Engine, after ``src/repro/core/engine.py``.

One ``meta_step`` = K unrolled base optimizer steps + one meta update, with
the hypergradient estimator resolved through the ``repro_torch.core.methods``
registry. The step is a function (state, base_batches, meta_batch) ->
(state, metrics) over trees of tensors; ``base_batches`` carries a leading
unroll axis of length K. Where JAX jits the step, the port runs it eagerly:
a Python loop takes the place of ``lax.scan``, and every value, the metrics
included, stays on the device until a caller reads it.

The step is method-agnostic: unroll -> ``method.local_terms`` -> identity
reduce (one device) -> ``method.finalize`` -> meta update. Its phases carry
``torch.profiler.record_function`` names, the counterpart of the JAX
package's ``obs.trace.phase`` scopes: ``base_unroll``, ``local_terms``
(with SAMA's ``meta_pass`` and ``cd_passes`` inside), ``finalize``,
``meta_update``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
from torch.profiler import record_function

from repro_torch import tree as tu
from repro_torch.core import methods as methods_mod
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.methods import HypergradMethod, MethodContext
from repro_torch.core.sama import global_norm, value_and_grad
from repro_torch.optim import Optimizer, OptState, apply_updates

Tree = Any


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """The ``repro.scale`` knobs as they ride on ``EngineConfig``: precision
    policy and microbatch count. The port takes only the identity (the f32
    policy, microbatch 1), under which the JAX package's policy boundary
    and accumulation are the identity too; any other value raises until
    ``scale/`` is ported."""

    policy: str = "f32"
    microbatch: int = 1

    def __post_init__(self):
        if self.policy != "f32" or self.microbatch != 1:
            raise NotImplementedError(
                f"ScaleConfig(policy={self.policy!r}, microbatch={self.microbatch}): "
                "precision policies and microbatching wait for the port of scale/; "
                "only the identity (f32, microbatch 1) runs")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``method`` is a registry name or a HypergradMethod instance; the
    remaining knobs feed the built-in factories."""

    method: Union[str, HypergradMethod] = "sama"
    unroll_steps: int = 1
    alpha: float = 1.0  # SAMA perturbation scale
    base_nudge: bool = True
    adapt_clip: float = 0.0  # see SAMAConfig.adapt_clip
    scale: ScaleConfig = ScaleConfig()

    def __post_init__(self):
        if isinstance(self.method, str) and self.method not in methods_mod.available_methods():
            raise ValueError(
                f"method {self.method!r} not registered; have {methods_mod.available_methods()}")

    def resolve(self) -> HypergradMethod:
        return methods_mod.resolve_method(self.method, self)


class EngineState(NamedTuple):
    theta: Tree
    base_opt_state: OptState
    lam: Tree
    meta_opt_state: OptState
    step: torch.Tensor  # 0-d int32


def init_state(theta: Tree, lam: Tree, base_opt: Optimizer, meta_opt: Optimizer) -> EngineState:
    return EngineState(
        theta=theta,
        base_opt_state=base_opt.init(theta),
        lam=lam,
        meta_opt_state=meta_opt.init(lam),
        step=torch.zeros((), dtype=torch.int32, device=tu.tree_leaves(theta)[0].device),
    )


def _unroll_base(spec: BilevelSpec, base_opt: Optimizer, theta, opt_state, lam, base_batches):
    """K base optimizer steps. Carries the last base gradient and the
    optimizer state at which it was computed: SAMA's adaptation matrix is
    evaluated there (paper footnote 2: no extra backward pass). Returns
    ``(theta, opt_state, g_last, state_at_g, losses (K,))``."""

    k = tu.tree_leaves(base_batches)[0].shape[0]
    if k < 1:
        raise ValueError("the base unroll needs at least one batch")
    grad_fn = value_and_grad(spec.base_scalar, 0)
    losses = []
    for i in range(k):
        batch = tu.tree_map(lambda x: x[i], base_batches)
        loss, g = grad_fn(theta, lam, batch)
        state_at_g = opt_state
        upd, opt_state = base_opt.update(g, opt_state, theta)
        theta = apply_updates(theta, upd)
        losses.append(loss)
    return theta, opt_state, g, state_at_g, torch.stack(losses)


def make_context(base_opt: Optimizer, state: EngineState, base_batches, meta_batch, *,
                 theta, base_opt_state, g_base) -> MethodContext:
    """The MethodContext a hypergradient method consumes."""

    return MethodContext(
        base_opt=base_opt,
        theta0=state.theta,
        theta=theta,
        lam=state.lam,
        g_base=g_base,
        base_opt_state=base_opt_state,
        base_batches=base_batches,
        last_batch=tu.tree_map(lambda x: x[-1], base_batches),
        meta_batch=meta_batch,
    )


def step_metrics(method: HypergradMethod, terms, hyper, base_losses) -> Dict[str, torch.Tensor]:
    """The uniform metric dict, on the device. ``eps`` is kept for every
    method (zero without a step-size notion) so logs stay columnar."""

    metrics = {
        "base_loss": torch.mean(base_losses),
        "meta_loss": terms["meta_loss"],
        "hypergrad_norm": global_norm(hyper),
        "eps": torch.zeros((), dtype=torch.float32, device=base_losses.device),
    }
    for k, v in method.metrics(terms).items():
        metrics[k] = v
    return metrics


def guarded_meta_update(meta_opt: Optimizer, hyper, theta_post, state: EngineState):
    """The meta-level update. Returns ``(lam, meta_state, theta_post)``.
    The JAX package gates it on finiteness under loss-scaled low-precision
    policies only; the gate comes with the port of ``scale/``."""

    upd, m_state = meta_opt.update(hyper, state.meta_opt_state, state.lam)
    return apply_updates(state.lam, upd), m_state, theta_post


def make_meta_step(
    spec: BilevelSpec,
    base_opt: Optimizer,
    meta_opt: Optimizer,
    cfg: EngineConfig = EngineConfig(),
) -> Callable[[EngineState, Any, Any], Tuple[EngineState, Dict[str, torch.Tensor]]]:
    """The method-agnostic meta-step function."""

    method = cfg.resolve()

    def meta_step(state: EngineState, base_batches, meta_batch):
        with record_function("base_unroll"):
            theta, b_state, g_base, st_at_g, base_losses = _unroll_base(
                spec, base_opt, state.theta, state.base_opt_state, state.lam, base_batches)
        ctx = make_context(base_opt, state, base_batches, meta_batch,
                           theta=theta, base_opt_state=st_at_g, g_base=g_base)
        with record_function("local_terms"):
            terms = methods_mod.validate_terms(method, method.local_terms(spec, ctx))
        with record_function("finalize"):
            hyper, theta_post = method.finalize(terms, ctx)
        with record_function("meta_update"):
            lam, m_state, theta_post = guarded_meta_update(meta_opt, hyper, theta_post, state)
        new_state = EngineState(theta=theta_post, base_opt_state=b_state, lam=lam,
                                meta_opt_state=m_state, step=state.step + 1)
        return new_state, step_metrics(method, terms, hyper, base_losses)

    return meta_step


def packed_read(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metric dict as Python floats through one device-to-host copy."""

    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def run_loop(step_fn, state, batch_iter, num_steps: int,
             log_every: int = 0) -> Tuple[Any, List[Dict[str, float]]]:
    """The shared training loop: drive ``step_fn`` over an iterator of
    (base_batches[K], meta_batch), collecting the metrics at the
    ``log_every`` cadence (and on the last step). Metrics are read only
    there, in one device-to-host copy per logged step (:func:`packed_read`);
    between logs the loop never waits on the device. (The JAX loop's
    ``on_step`` hook serves checkpointing, which comes with its port.)"""

    history = []
    for i in range(num_steps):
        base_batches, meta_batch = next(batch_iter)
        state, metrics = step_fn(state, base_batches, meta_batch)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            history.append(packed_read(metrics) | {"step": i})
    return state, history


class Engine:
    """Convenience single-process driver around the step function."""

    def __init__(self, spec, base_opt, meta_opt, cfg: EngineConfig = EngineConfig()):
        self.spec = spec
        self.base_opt = base_opt
        self.meta_opt = meta_opt
        self.cfg = cfg
        self.step_fn = make_meta_step(spec, base_opt, meta_opt, cfg)

    def init(self, theta, lam) -> EngineState:
        return init_state(theta, lam, self.base_opt, self.meta_opt)

    def run(self, state: EngineState, batch_iter, num_meta_steps: int, log_every: int = 0):
        """batch_iter yields (base_batches[K], meta_batch)."""

        return run_loop(self.step_fn, state, batch_iter, num_meta_steps, log_every)
