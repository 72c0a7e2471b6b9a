"""The meta-training Engine, after ``src/repro/core/engine.py``.

One ``meta_step`` = K unrolled base optimizer steps + one meta update, with
the hypergradient estimator resolved through the ``repro_torch.core.methods``
registry. The step is a function (state, base_batches, meta_batch) ->
(state, metrics) over trees of tensors; ``base_batches`` carries a leading
unroll axis of length K. Where JAX jits the step, the port runs it eagerly:
a Python loop takes the place of ``lax.scan``, and every value, the metrics
included, stays on the device until a caller reads it.

The step is method-agnostic: unroll -> ``method.local_terms`` -> identity
reduce (one device) -> ``method.finalize`` -> meta update. The
distributed schedules (``repro_torch.launch.distributed``) drive the same
protocol: the single-sync one puts its one bucketed all-reduce between
stages 2 and 3, the global-batch one runs this step under a reducer. ``cfg.scale``
(``repro_torch.scale``) applies a precision policy's cast boundary to both
levels, accumulates every batch-sized backward pass over M microbatches,
and, under a loss-scaling policy (f16), skips a base step or the meta
update whose gradient is not finite and runs the loss-scale automaton;
every gate is a 0-d tensor on the device. Its phases carry
``torch.profiler.record_function`` names, the counterpart of the JAX
package's ``obs.trace.phase`` scopes: ``base_unroll``, ``local_terms``
(with SAMA's ``meta_pass`` and ``cd_passes`` inside), ``finalize``,
``meta_update``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from repro_torch import tree as tu
from repro_torch.core import methods as methods_mod
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.methods import HypergradMethod, MethodContext
from repro_torch.core.sama import global_norm
from repro_torch.optim import Optimizer, OptState, apply_updates
from repro_torch.scale import accum as accum_mod
from repro_torch.scale import policy as policy_mod
from repro_torch.scale.policy import LossScaleState, ScaleConfig

Tree = Any


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``method`` is a registry name or a HypergradMethod instance; the
    remaining knobs feed the built-in factories. ``scale`` carries the
    precision policy and microbatch count; the default is the identity
    (f32, no microbatching), the paper-exact step."""

    method: Union[str, HypergradMethod] = "sama"
    unroll_steps: int = 1
    alpha: float = 1.0  # SAMA perturbation scale
    base_nudge: bool = True
    adapt_clip: float = 0.0  # see SAMAConfig.adapt_clip
    # baseline-specific knobs
    neumann_terms: int = 5
    neumann_scale: float = 0.1
    cg_iters: int = 5
    cg_damping: float = 1e-3
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
    #: the dynamic loss-scale automaton; None (no leaves, so the 63-leaf
    #: checkpoints of the f32 and bf16 policies keep their layout) unless
    #: the policy scales losses
    scale: Optional[LossScaleState] = None


def init_state(theta: Tree, lam: Tree, base_opt: Optimizer, meta_opt: Optimizer, *,
               scale: Optional[ScaleConfig] = None) -> EngineState:
    """``scale``: the EngineConfig's ScaleConfig, so that a loss-scaling
    policy (f16) gets its LossScaleState seeded; omitting it keeps the
    f32/bf16 default (no scale state)."""

    device = tu.tree_leaves(theta)[0].device
    return EngineState(
        theta=theta,
        base_opt_state=base_opt.init(theta),
        lam=lam,
        meta_opt_state=meta_opt.init(lam),
        step=torch.zeros((), dtype=torch.int32, device=device),
        scale=policy_mod.init_scale_state((scale or ScaleConfig()).resolve(), device=device),
    )


def _unroll_base(spec: BilevelSpec, base_opt: Optimizer, theta, opt_state, lam, base_batches,
                 *, scale_cfg: Optional[ScaleConfig] = None,
                 scale_state: Optional[LossScaleState] = None, grad_reduce=None):
    """K base optimizer steps. Carries the last base gradient and the
    optimizer state at which it was computed: SAMA's adaptation matrix is
    evaluated there (paper footnote 2: no extra backward pass).

    ``scale_cfg.microbatch`` splits each base batch into M accumulated
    microbatches. ``scale_state`` (a loss-scaling policy) multiplies each
    microbatch loss by the live scale before its backward pass and skips
    the update on a non-finite gradient: parameters, moments and the
    carried (g, state-at-g) pair keep their values, and the automaton
    backs off. ``grad_reduce`` is the single-sync schedule's per-step DDP
    reduce (``launch.distributed``): it runs on the gradient accumulated
    over the microbatches, so a base step makes one all-reduce for every M.

    Returns ``(theta, opt_state, g_last, state_at_g, losses (K,),
    scale_state, any_finite)``: ``any_finite`` (0-d bool, True without
    scaling) says whether any base step applied. When every step skipped,
    ``g_last`` is the zero init and the meta level must not use it (the
    caller's meta-update gate ANDs the flag in)."""

    cfg = scale_cfg or ScaleConfig()
    policy = cfg.resolve()
    if policy.dynamic_scaling and scale_state is None:
        raise ValueError(
            f"policy {policy.name!r} scales losses but the state carries no LossScaleState: "
            "build the state with init_state(..., scale=engine_cfg.scale)")
    k = tu.tree_leaves(base_batches)[0].shape[0]
    if k < 1:
        raise ValueError("the base unroll needs at least one batch")
    device = tu.tree_leaves(theta)[0].device
    any_finite = torch.full((), scale_state is None, dtype=torch.bool, device=device)
    g_last = state_at_g = None
    if scale_state is not None:
        # the zero init, as 0-d zeros that the first select broadcasts
        g_last = tu.tree_map(lambda x: x.new_zeros(()), theta)
        state_at_g = opt_state
    losses = []
    for i in range(k):
        batch = tu.tree_map(lambda x: x[i], base_batches)
        loss, g = accum_mod.microbatch_value_and_grad(
            spec.base_scalar, theta, lam, batch, cfg.microbatch, policy.accum_torch,
            scale=scale_state)
        if grad_reduce is not None:
            g = grad_reduce(g)
        losses.append(loss)
        if scale_state is None:
            state_at_g, g_last = opt_state, g
            upd, opt_state = base_opt.update(g, opt_state, theta)
            theta = apply_updates(theta, upd)
            continue
        # a non-finite g makes a non-finite update, which the selects drop
        # (the JAX package zeroes g first; the kept values are the same).
        # The selects write into buffers this loop owns (the fresh update
        # and gradient, its own state-at-g after step 1), so only step 1's
        # state-at-g is a new parameter-sized tree
        finite = policy_mod.all_finite(g)
        upd, st_new = base_opt.update(g, opt_state, theta)
        applied = apply_updates(theta, upd)
        del upd
        theta = policy_mod.select_tree(finite, applied, theta, out=applied)
        # a skipped step gives no usable gradient: keep the previous
        # (g, state-at-g) pair so SAMA's adaptation stays finite
        g_last = policy_mod.select_tree(finite, g, g_last, out=g)
        del g
        # at step 0 state-at-g is the incoming state either way
        if i == 1:
            state_at_g = policy_mod.select_tree(finite, opt_state, state_at_g)
        elif i > 1:
            state_at_g = policy_mod.select_tree(finite, opt_state, state_at_g, out=state_at_g)
        opt_state = policy_mod.select_tree(finite, st_new, opt_state, out=st_new)
        del st_new
        scale_state = policy_mod.update_scale(scale_state, finite, policy)
        any_finite = torch.logical_or(any_finite, finite)
    return theta, opt_state, g_last, state_at_g, torch.stack(losses), scale_state, any_finite


def make_context(base_opt: Optimizer, state: EngineState, base_batches, meta_batch, *,
                 theta, base_opt_state, g_base, loss_scale=None) -> MethodContext:
    """The MethodContext a hypergradient method consumes. ``loss_scale``
    (the post-unroll dynamic scale under an f16 policy) lets methods
    protect their own backward passes (``MethodContext.loss_scale``)."""

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
        loss_scale=loss_scale,
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


def guarded_meta_update(meta_opt: Optimizer, hyper, theta_post, state: EngineState, *,
                        theta_pre, guard: bool, base_ok=None):
    """The meta-level update, gated on finiteness under ``guard`` (a
    loss-scaling policy): a non-finite hypergradient or nudged theta skips
    the whole meta update (lam, meta moments and the finalize post-update
    of theta, which falls back to ``theta_pre``). ``base_ok``, the unroll's
    any-finite flag, is ANDed in: when every base step skipped, g_base is
    the zero init and the hypergradient is finite garbage.

    Returns ``(lam, meta_state, theta_post, finite)``; ``finite`` is None
    unguarded, else the 0-d gate, which callers feed to
    ``policy.backoff_on`` so that the automaton sees hypergradient
    overflow."""

    upd, m_state = meta_opt.update(hyper, state.meta_opt_state, state.lam)
    lam = apply_updates(state.lam, upd)
    if not guard:
        return lam, m_state, theta_post, None
    finite = policy_mod.all_finite({"hyper": hyper, "theta": theta_post})
    if base_ok is not None:
        finite = torch.logical_and(finite, base_ok)
    lam = policy_mod.select_tree(finite, lam, state.lam)
    m_state = policy_mod.select_tree(finite, m_state, state.meta_opt_state)
    theta_post = policy_mod.select_tree(finite, theta_post, theta_pre)
    return lam, m_state, theta_post, finite


def make_meta_step(
    spec: BilevelSpec,
    base_opt: Optimizer,
    meta_opt: Optimizer,
    cfg: EngineConfig = EngineConfig(),
) -> Callable[[EngineState, Any, Any], Tuple[EngineState, Dict[str, torch.Tensor]]]:
    """The method-agnostic meta-step function. ``cfg.scale`` applies the
    precision policy's cast boundary to both levels (the spec is wrapped
    once, so the unroll and the hypergradient passes see one boundary)
    and microbatch accumulation to every batch-sized backward pass. Under
    a loss-scaling policy the metrics add ``loss_scale`` (the post-step
    scale) and ``meta_skipped`` (1.0 where the meta update was skipped)."""

    method = cfg.resolve()
    policy = cfg.scale.resolve()
    spec = policy_mod.apply_to_spec(spec, policy)
    micro = cfg.scale.microbatch

    def meta_step(state: EngineState, base_batches, meta_batch):
        with record_function("base_unroll"):
            (theta, b_state, g_base, st_at_g, base_losses, scale_state,
             base_ok) = _unroll_base(spec, base_opt, state.theta, state.base_opt_state,
                                     state.lam, base_batches, scale_cfg=cfg.scale,
                                     scale_state=state.scale)
        ctx = make_context(base_opt, state, base_batches, meta_batch,
                           theta=theta, base_opt_state=st_at_g, g_base=g_base,
                           loss_scale=scale_state.scale if scale_state is not None else None)
        with record_function("local_terms"):
            terms = methods_mod.validate_terms(method, accum_mod.microbatch_local_terms(
                method, spec, ctx, micro, policy.accum_torch))
        with record_function("finalize"):
            hyper, theta_post = method.finalize(terms, ctx)
        with record_function("meta_update"):
            lam, m_state, theta_post, meta_ok = guarded_meta_update(
                meta_opt, hyper, theta_post, state, theta_pre=theta,
                guard=policy.dynamic_scaling, base_ok=base_ok)
            if meta_ok is not None:  # hypergradient overflow backs the scale off
                scale_state = policy_mod.backoff_on(scale_state, meta_ok, policy)
        new_state = EngineState(theta=theta_post, base_opt_state=b_state, lam=lam,
                                meta_opt_state=m_state, step=state.step + 1, scale=scale_state)
        metrics = step_metrics(method, terms, hyper, base_losses)
        if meta_ok is not None:
            # present whenever the policy scales: the post-step scale and the
            # gate's verdict ride the metric dict, read at the log cadence
            metrics["loss_scale"] = scale_state.scale
            metrics["meta_skipped"] = 1.0 - meta_ok.to(torch.float32)
        return new_state, metrics

    return meta_step


def packed_read(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metric dict as Python floats through one device-to-host copy."""

    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def run_loop(step_fn, state, batch_iter, num_steps: int, log_every: int = 0,
             on_step=None) -> Tuple[Any, List[Dict[str, float]]]:
    """The shared training loop: drive ``step_fn`` over an iterator of
    (base_batches[K], meta_batch), collecting the metrics at the
    ``log_every`` cadence (and on the last step). Metrics are read only
    there, in one device-to-host copy per logged step (:func:`packed_read`);
    between logs the loop never waits on the device. ``on_step(i, state)``
    runs after every step (checkpoint hooks)."""

    history = []
    for i in range(num_steps):
        base_batches, meta_batch = next(batch_iter)
        state, metrics = step_fn(state, base_batches, meta_batch)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            history.append(packed_read(metrics) | {"step": i})
        if on_step is not None:
            on_step(i, state)
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
        return init_state(theta, lam, self.base_opt, self.meta_opt, scale=self.cfg.scale)

    def run(self, state: EngineState, batch_iter, num_meta_steps: int, log_every: int = 0):
        """batch_iter yields (base_batches[K], meta_batch)."""

        return run_loop(self.step_fn, state, batch_iter, num_meta_steps, log_every)
