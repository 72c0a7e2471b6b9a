"""Microbatch gradient accumulation for the bilevel step, after
``src/repro/scale/accum.py``.

Splits a batch with leading dim B into M microbatches of B/M and runs the
backward pass once per microbatch in a Python loop (the JAX package's
``lax.scan``), accumulating in the policy's ``accum_dtype``: activation
memory becomes O(B/M) while the arithmetic stays the full-batch mean.

The sums are taken in place, where XLA reuses the scan's buffers: a
gradient over parameters accumulates in the ``.grad`` of leaves made for
the purpose (autograd adds each microbatch's gradient into it), so the
M > 1 step holds one parameter-sized gradient as the M = 1 step does
(a functional ``acc + g`` would hold three: gemma3-1b's peak grew from
56.5 to 66.2 GB at M = 2 that way, NVIDIA H100 80GB HBM3, 700 W,
``chip_smoke.py`` phase 15(b)); other terms accumulate into a copy of
the first one with ``add_``. The order of the sums is the JAX package's.
Three sites:

1. the base unroll's per-step gradient (``microbatch_value_and_grad``,
   also where dynamic loss scaling applies: each microbatch loss is
   multiplied by the live scale before its backward pass, the accumulated
   gradient is unscaled once);
2. the hypergradient stage (``microbatch_local_terms``): a method with a
   ``micro_local_terms`` hook gets its own staged decomposition (SAMA:
   accumulate g_meta over meta microbatches, v and eps once, accumulate
   the central difference over last-batch microbatches); otherwise a
   method with a linear reduce contract falls back to the virtual-shard
   mean (each microbatch one more data shard, the contract terms
   averaged). Nonlinear contracts (CG, Neumann, iterdiff) are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.scale.policy import LossScaleState

Tree = Any


def split_batch(batch: Tree, m: int) -> Tree:
    """Every leaf [B, ...] -> [m, B // m, ...] (a view). Every leading dim
    must be divisible by m (the planner proposes only divisors; a
    hand-picked M fails here)."""

    if m < 1:
        raise ValueError(f"microbatch count must be >= 1, got {m}")

    def one(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(
                f"batch dim {b} not divisible by microbatch count {m}; pick M from "
                "repro_torch.scale.plan_microbatch (it only proposes divisors) or pad "
                "the batch")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    return tu.tree_map(one, batch)


def accumulate_mean(term_fn: Callable[[Tree], Tree], split: Tree, m: int,
                    accum_dtype: torch.dtype) -> Tree:
    """mean over i of term_fn(microbatch i), accumulated in ``accum_dtype``
    over one loop, in place in a copy of the first term. ``split`` carries
    the leading m axis (``split_batch``); the result keeps
    ``accum_dtype``: callers cast back where the consumer needs another
    dtype."""

    acc = None
    for i in range(m):
        term = term_fn(tu.tree_map(lambda x: x[i], split))
        if acc is None:
            acc = tu.tree_map(lambda t: t.to(accum_dtype, copy=True), term)
        else:
            tu.tree_map(lambda a, t: a.add_(t.to(accum_dtype)), acc, term)
        del term
    return tu.tree_map(lambda a: a.div_(m), acc)


def accumulated_value_and_grad(loss_fn: Callable, theta: Tree, lam: Tree, batch: Tree, m: int,
                               accum_dtype: torch.dtype,
                               loss_scale: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, Tree]:
    """The mean loss (f32) and its gradient with respect to theta (in
    ``accum_dtype``) over M microbatches of ``batch``: one backward pass
    per microbatch, each adding its gradient into one buffer per leaf
    (the ``.grad`` of a leaf that holds theta's values in
    ``accum_dtype``), the JAX package's sum in its order. ``loss_scale``
    multiplies each microbatch loss before its backward pass; the sums
    are divided by M and then by the scale."""

    leaves, paths = tu.tree_flatten(theta)
    live = [x.detach().to(accum_dtype).requires_grad_(True) for x in leaves]
    live_theta = tu.tree_unflatten(paths, live)
    split = split_batch(batch, m)
    loss_sum = None
    for i in range(m):
        mb = tu.tree_map(lambda x: x[i], split)
        with torch.enable_grad():
            loss = loss_fn(live_theta, lam, mb)
            if loss_scale is not None:
                loss = loss * loss_scale
        loss.backward()
        loss = loss.detach().to(torch.float32)
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in live]
    loss, grads = loss_sum / m, [g.div_(m) for g in grads]
    if loss_scale is not None:
        loss, grads = loss / loss_scale, [g.div_(loss_scale) for g in grads]
    from repro_torch.core import sync  # core imports this package

    # the global-batch schedule's reduce, once on the sum of the M passes
    return loss, sync.mean(tu.tree_unflatten(paths, grads))


def microbatch_value_and_grad(loss_fn: Callable, theta: Tree, lam: Tree, batch: Tree, m: int,
                              accum_dtype: torch.dtype, *,
                              scale: Optional[LossScaleState] = None) -> Tuple[torch.Tensor, Tree]:
    """(loss, dloss/dtheta) over the full batch through M accumulated
    microbatch backward passes (:func:`accumulated_value_and_grad`). With
    a live ``scale`` each microbatch loss is multiplied by ``scale.scale``
    before its backward pass and the accumulated gradient is unscaled once
    at the end; callers check finiteness and run the automaton
    (``policy.update_scale``)."""

    from repro_torch.core.sama import scaled_value_and_grad  # core imports this package

    s = scale.scale if scale is not None else None
    if m <= 1:
        loss, g = scaled_value_and_grad(loss_fn, 0, s)(theta, lam, batch)
        return loss.to(torch.float32), g
    loss, g = accumulated_value_and_grad(loss_fn, theta, lam, batch, m, accum_dtype, s)
    # the parameter leaf's dtype, so the M > 1 path is a drop-in for M = 1
    return loss, tu.tree_map(lambda x, t: x.to(t.dtype), g, theta)


def microbatch_local_terms(method, spec, ctx, m: int, accum_dtype: torch.dtype):
    """Stage 1 (``local_terms``) under M-way microbatching: the method's
    ``micro_local_terms`` hook where it has one, else the virtual-shard
    mean for a linear contract. M <= 1 is the plain call."""

    if m <= 1:
        return method.local_terms(spec, ctx)

    hook = getattr(method, "micro_local_terms", None)
    if hook is not None:
        return hook(spec, ctx, m, accum_dtype)

    contract = method.reduce_contract
    if not contract.linear:
        raise ValueError(
            f"hypergrad method {method.name!r} declares a nonlinear reduce "
            "contract: averaging its per-microbatch estimates is not the "
            "method's own estimator on the full batch (the same reason "
            "make_manual_step refuses it). Run it with microbatch=1, or "
            "implement micro_local_terms on the method.")

    meta_split = split_batch(ctx.meta_batch, m)
    last_split = split_batch(ctx.last_batch, m)

    def term(mb):
        meta_mb, last_mb = mb
        ctx_m = dataclasses.replace(ctx, meta_batch=meta_mb, last_batch=last_mb)
        terms = method.local_terms(spec, ctx_m)
        extra = set(terms) - set(contract.terms)
        if extra:
            raise ValueError(
                f"{method.name}: local_terms produced non-contract terms {sorted(extra)}: "
                "the generic virtual-shard accumulator only knows how to mean-reduce "
                "contract terms; implement micro_local_terms to handle method-private state")
        return terms

    return accumulate_mean(term, (meta_split, last_split), m, accum_dtype)
