"""SAMA meta-gradient (paper Sec. 3, Eqs. 3-5), after
``src/repro/core/sama.py``.

The meta gradient is approximated by

    dL_meta/dlam  ~=  -(d/dlam L_base(theta+, lam) - d/dlam L_base(theta-, lam)) / (2 eps)

with
    theta+- = theta* +- eps * v
    v       = (du/dg) .* dL_meta/dtheta*          (algorithmic adaptation)
    eps     = alpha / ||v||_2                      (DARTS-style step size)

Only first-order backward passes appear:
    pass 1: g_meta = grad_theta L_meta
    pass 2: grad_lam L_base(theta+)
    pass 3: grad_lam L_base(theta-)

The adaptation diagonal du/dg is analytic (``Optimizer.adaptation``) and
reuses the base gradient of the last unroll step. With a fused
``adapt_product`` (adam, adamw) the product and the sum of squares that
``eps`` needs come out of one kernel pass.

Passes 2 and 3 differentiate with respect to lam only, and lam enters only
through the weight net after the per-example losses: theta+ and theta-
carry no gradient, so the model's forward at them records no graph, keeps
no activations and launches no attention backward (XLA drops that work
from the JAX step by itself).

Gradients are ``torch.autograd.grad`` over fresh leaves that require grad
(:func:`value_and_grad`); no state tensor ever requires grad. The phases
carry ``torch.profiler.record_function`` names, the counterpart of the
JAX package's ``obs.trace.phase``. Under a loss-scaling precision policy
(f16, ``repro_torch.scale``) every backward pass here takes the live scale
(``loss_scale``): the loss is multiplied by it before the backward pass so
the low-precision gradients stay representable, and the results are
divided by it again (:func:`scaled_value_and_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch import tree as tu
from repro_torch.core import sync
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.optim import Optimizer, OptState

Tree = Any


@dataclasses.dataclass(frozen=True)
class SAMAConfig:
    alpha: float = 1.0  # perturbation scale; paper finds 1.0 robust (Sec 3.2)
    adapt: bool = True  # False => SAMA-NA ablation (no algorithmic adaptation)
    base_nudge: bool = True  # theta <- theta - eps*v at meta updates
    eps_floor: float = 1e-12
    # clip |du/dg| at adapt_clip (the cold-state Adam pathology, DESIGN.md
    # section 6); 0 disables (paper-exact)
    adapt_clip: float = 0.0


class SAMAResult(NamedTuple):
    hypergrad: Tree  # dL_meta/dlam
    v: Tree  # perturbation direction (du/dg .* g_meta)
    eps: torch.Tensor  # scalar step size
    meta_loss: torch.Tensor


def value_and_grad(loss_fn, argnums: int):
    """``jax.value_and_grad`` for a loss over trees of tensors: the tree at
    position ``argnums`` is replaced by detached leaves that require grad,
    and ``torch.autograd.grad`` returns a tree of gradients like it (zeros
    for leaves the loss does not reach). Returns (loss detached, grads).
    Under the global-batch schedule's reducer (``core.sync``) the grads
    are averaged over the data shards; the loss stays the shard's."""

    def call(*args):
        args = list(args)
        leaves, paths = tu.tree_flatten(args[argnums])
        live = [x.detach().requires_grad_(True) for x in leaves]
        args[argnums] = tu.tree_unflatten(paths, live)
        with torch.enable_grad():
            loss = loss_fn(*args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
        return loss.detach(), sync.mean(tu.tree_unflatten(paths, grads))

    return call


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = tu.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def adaptation_product(
    base_opt: Optimizer,
    base_opt_state: OptState,
    theta: Tree,
    g_base: Optional[Tree],
    g_meta: Tree,
    cfg: SAMAConfig,
):
    """``v = du/dg .* g_meta`` from an already computed meta gradient.
    Returns ``(v, v_sumsq)``: ``v_sumsq`` is ``sum(v^2)`` when it came from
    the fused kernel (``Optimizer.adapt_product``), else None and callers
    take ``global_norm(v)``. The fused path is skipped under
    ``adapt_clip`` (it clips the raw diagonal, which the kernel never
    materializes) and for optimizers without one."""

    if not cfg.adapt:
        return g_meta, None
    if g_base is None:
        raise ValueError("algorithmic adaptation needs the last base gradient g_base")
    if base_opt.adapt_product is not None and not cfg.adapt_clip:
        return base_opt.adapt_product(g_base, base_opt_state, theta, g_meta)
    a = base_opt.adaptation(g_base, base_opt_state, theta)
    if cfg.adapt_clip:
        a = tu.tree_map(lambda ai: torch.clamp(ai, -cfg.adapt_clip, cfg.adapt_clip), a)
    return tu.tree_map(lambda ai, gi: ai * gi, a, g_meta), None


def step_size(v: Tree, v_sumsq: Optional[torch.Tensor], cfg: SAMAConfig) -> torch.Tensor:
    """eps = alpha / ||v|| (DARTS-style), floored. ``v_sumsq`` (from the
    fused adaptation kernel) skips the separate global_norm pass."""

    norm = torch.sqrt(v_sumsq) if v_sumsq is not None else global_norm(v)
    return cfg.alpha / torch.clamp_min(norm, cfg.eps_floor)


def perturbation_direction(
    spec: BilevelSpec,
    theta: Tree,
    lam: Tree,
    meta_batch,
    *,
    base_opt: Optimizer,
    base_opt_state: OptState,
    g_base: Optional[Tree],
    cfg: SAMAConfig,
    loss_scale: Optional[torch.Tensor] = None,
):
    """Backward pass 1 + ``adaptation_product``. Returns
    ``(meta_loss, v, v_sumsq)``. ``loss_scale`` (f16 policy) multiplies
    the meta loss before its backward pass; the returned loss and
    gradient are unscaled."""

    with record_function("meta_pass"):
        meta_loss, g_meta = scaled_value_and_grad(spec.meta_scalar, 0, loss_scale)(
            theta, lam, meta_batch)
        v, v_sumsq = adaptation_product(base_opt, base_opt_state, theta, g_base, g_meta, cfg)
    return meta_loss, v, v_sumsq


def scaled_value_and_grad(loss_fn, argnums: int, loss_scale: Optional[torch.Tensor]):
    """:func:`value_and_grad` with the dynamic loss scale applied inside
    the differentiated function (so every gradient in the low-precision
    region carries it) and divided out of both results. The plain
    :func:`value_and_grad` when ``loss_scale`` is None."""

    if loss_scale is None:
        return value_and_grad(loss_fn, argnums)

    def scaled(*args):
        return loss_fn(*args) * loss_scale

    def call(*args):
        loss, g = value_and_grad(scaled, argnums)(*args)
        return loss / loss_scale, tu.tree_map(lambda x: x / loss_scale, g)

    return call


def central_difference_hypergrad(
    spec: BilevelSpec,
    theta: Tree,
    lam: Tree,
    base_batch,
    v: Tree,
    *,
    cfg: SAMAConfig,
    v_sumsq: Optional[torch.Tensor] = None,
    loss_scale: Optional[torch.Tensor] = None,
):
    """Backward passes 2 + 3, the finite-difference mixed second derivative

        d^2 L_base / dlam dtheta . v
            ~= (grad_lam L_base(theta + eps v) - grad_lam L_base(theta - eps v)) / (2 eps)
    """

    with record_function("cd_passes"):
        eps = step_size(v, v_sumsq, cfg)
        theta_p, theta_m = perturbed_params(theta, v, eps)
        delta = central_difference_delta(spec, theta_p, theta_m, lam, base_batch,
                                         loss_scale=loss_scale)
        hyper = tu.tree_map(lambda d: -d / (2.0 * eps), delta)
    return hyper, eps


def perturbed_params(theta: Tree, v: Tree, eps: torch.Tensor):
    """(theta + eps v, theta - eps v), cast per leaf to theta's dtype."""

    theta_p = tu.tree_map(lambda t, vi: t + eps * vi.to(t.dtype), theta, v)
    theta_m = tu.tree_map(lambda t, vi: t - eps * vi.to(t.dtype), theta, v)
    return theta_p, theta_m


def central_difference_delta(spec: BilevelSpec, theta_p, theta_m, lam, base_batch, *,
                             loss_scale: Optional[torch.Tensor] = None):
    """``grad_lam L_base(theta+) - grad_lam L_base(theta-)`` on one batch.
    Linear in the batch mean, so microbatch accumulation of this delta
    (``repro_torch.scale.accum``) gives the full-batch value; the
    1/(2 eps) scaling happens once in the caller. ``loss_scale`` scales
    both backward passes and is divided out of the returned delta, which
    lies in lam's f32 gradient domain."""

    if loss_scale is None:
        scalar = spec.base_scalar
    else:
        def scalar(th, la, b):
            return spec.base_scalar(th, la, b) * loss_scale

    grad_lam = value_and_grad(scalar, 1)
    _, gl_p = grad_lam(theta_p, lam, base_batch)
    _, gl_m = grad_lam(theta_m, lam, base_batch)
    delta = tu.tree_map(lambda p, m: p - m, gl_p, gl_m)
    if loss_scale is not None:
        delta = tu.tree_map(lambda d: d / loss_scale, delta)
    return delta


def sama_hypergrad(
    spec: BilevelSpec,
    theta: Tree,
    lam: Tree,
    base_batch,
    meta_batch,
    *,
    base_opt: Optimizer,
    base_opt_state: OptState,
    g_base: Optional[Tree] = None,
    cfg: SAMAConfig = SAMAConfig(),
) -> SAMAResult:
    """The full single-device SAMA meta gradient."""

    meta_loss, v, v_sumsq = perturbation_direction(
        spec, theta, lam, meta_batch,
        base_opt=base_opt, base_opt_state=base_opt_state, g_base=g_base, cfg=cfg,
    )
    hyper, eps = central_difference_hypergrad(spec, theta, lam, base_batch, v, cfg=cfg,
                                              v_sumsq=v_sumsq)
    return SAMAResult(hypergrad=hyper, v=v, eps=eps, meta_loss=meta_loss)


def apply_base_nudge(theta: Tree, v: Tree, eps: torch.Tensor, cfg: SAMAConfig) -> Tree:
    """theta <- theta - eps*v (paper Sec. 3.2, final paragraph)."""

    if not cfg.base_nudge:
        return theta
    return tu.tree_map(lambda t, vi: (t - eps * vi.to(t.dtype)).to(t.dtype), theta, v)
