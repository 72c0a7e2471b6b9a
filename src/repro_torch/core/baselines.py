"""Baseline hypergradient algorithms the paper compares SAMA against
(Fig. 1 table, Tables 2/8/9), after ``src/repro/core/baselines.py``:
iterative differentiation, Neumann series, conjugate gradient, and T1-T2
(DARTS one-step).

All of these compute dL_meta/dlam for the same BilevelSpec, so the Engine
swaps them in with a config string. The second-order ones use exact
autograd Hessian-vector products, which is what makes them slow and memory
hungry at scale. Python loops take the place of ``fori_loop`` and ``scan``.

The passes that differentiate twice (:func:`hvp`, :func:`mixed_vjp` and
:func:`iterdiff_hypergrad`'s whole re-unroll) run inside
``dispatch.second_order()``: the port's kernels are first order only, so
those passes take the plain route on the card, attention with it (which
materializes the S x T scores). The first-order passes (the meta gradient
and the Engine's base unroll) stay on the kernels.

Like the reference, iterative differentiation differentiates through
Adam's ``sqrt(vhat)``: a coordinate whose base gradient is exactly 0 but
still depends on lam gives ``0 * inf = NaN`` in lam's hypergradient
(``torch.sqrt``'s backward at 0 is ``jnp.sqrt``'s). It is kept, not fixed.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

from repro_torch import tree as tu
from repro_torch.core import sync
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.sama import value_and_grad
from repro_torch.kernels import dispatch
from repro_torch.optim import Optimizer, apply_updates

Tree = Any


def _vdot(a: Tree, b: Tree) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(tu.tree_leaves(a), tu.tree_leaves(b)))


def _live(tree: Tree):
    """(tree of detached leaves that require grad, those leaves, paths)."""
    leaves, paths = tu.tree_flatten(tree)
    live = [x.detach().requires_grad_(True) for x in leaves]
    return tu.tree_unflatten(paths, live), live, paths


def _raw_grad(out: torch.Tensor, inputs: Sequence[torch.Tensor], *,
              create_graph: bool = False) -> List[torch.Tensor]:
    """``torch.autograd.grad`` with zeros for inputs ``out`` does not reach
    (and for an ``out`` that reaches none), as ``jax.grad`` gives them."""
    if not out.requires_grad:
        return [torch.zeros_like(x) for x in inputs]
    grads = torch.autograd.grad(out, inputs, create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _grad(out: torch.Tensor, inputs: Sequence[torch.Tensor], *,
          create_graph: bool = False) -> List[torch.Tensor]:
    """:func:`_raw_grad`; a first-order result is averaged over the data
    shards under the global-batch schedule's reducer (``core.sync``). The
    Hessian-vector and mixed products are linear in the batch, so their
    inner gradient (``create_graph``) stays the shard's and the outer one
    is reduced."""
    grads = _raw_grad(out, inputs, create_graph=create_graph)
    return grads if create_graph else sync.mean(grads)


def hvp(loss_theta, theta: Tree, vec: Tree) -> Tree:
    """Hessian-vector product d^2 L/dtheta^2 . vec, reverse over reverse
    (JAX takes forward over reverse: the same product up to rounding). One
    extra differentiation of the backward per call: the cost SAMA avoids."""

    with dispatch.second_order():
        th, live, paths = _live(theta)
        with torch.enable_grad():
            grads = _grad(loss_theta(th), live, create_graph=True)
            dot = _vdot(tu.tree_unflatten(paths, grads), vec)
        return tu.tree_unflatten(paths, _grad(dot, live))


def mixed_vjp(spec: BilevelSpec, theta, lam, base_batch, vec: Tree) -> Tree:
    """Exact  d^2 L_base / dlam dtheta . vec  =  grad_lam <grad_theta L_base, vec>."""

    with dispatch.second_order():
        th, th_live, th_paths = _live(theta)
        lm, lam_live, lam_paths = _live(lam)
        with torch.enable_grad():
            g_theta = _grad(spec.base_scalar(th, lm, base_batch), th_live, create_graph=True)
            dot = _vdot(tu.tree_unflatten(th_paths, g_theta), vec)
        return tu.tree_unflatten(lam_paths, _grad(dot, lam_live))


def _meta_grad(spec: BilevelSpec, theta, lam, meta_batch) -> Tree:
    return value_and_grad(spec.meta_scalar, 0)(theta, lam, meta_batch)[1]


def _neg(tree: Tree) -> Tree:
    return tu.tree_map(torch.neg, tree)


# ---------------------------------------------------------------------------
# Neumann series [Lorraine et al. 2020]
# ---------------------------------------------------------------------------


def neumann_hypergrad(
    spec: BilevelSpec, theta, lam, base_batch, meta_batch,
    *, num_terms: int = 5, scale: float = 0.1,
):
    """inv(H) g  ~=  scale * sum_i (I - scale*H)^i g, truncated."""

    g_meta = _meta_grad(spec, theta, lam, meta_batch)

    def loss_theta(th):
        return spec.base_scalar(th, lam, base_batch)

    p = acc = g_meta
    for _ in range(num_terms):
        hp = hvp(loss_theta, theta, p)
        p = tu.tree_map(lambda a, b: a - scale * b, p, hp)
        acc = tu.tree_map(torch.add, acc, p)
    inv_hvp = tu.tree_map(lambda x: scale * x, acc)
    return _neg(mixed_vjp(spec, theta, lam, base_batch, inv_hvp))


# ---------------------------------------------------------------------------
# Conjugate gradient [Rajeswaran et al. 2019, iMAML]
# ---------------------------------------------------------------------------


def cg_hypergrad(
    spec: BilevelSpec, theta, lam, base_batch, meta_batch,
    *, num_iters: int = 5, damping: float = 1e-3,
):
    """Solve (H + damping I) x = g_meta with CG, then -mixed_vjp(x)."""

    g_meta = _meta_grad(spec, theta, lam, meta_batch)

    def loss_theta(th):
        return spec.base_scalar(th, lam, base_batch)

    def matvec(x):
        h = hvp(loss_theta, theta, x)
        return tu.tree_map(lambda hx, xi: hx + damping * xi, h, x)

    x = tu.tree_map(torch.zeros_like, g_meta)
    r = p = g_meta
    rs = _vdot(r, r)
    for _ in range(num_iters):
        ap = matvec(p)
        alpha = rs / torch.clamp_min(_vdot(p, ap), 1e-30)
        x = tu.tree_map(lambda xi, pi: xi + alpha * pi, x, p)
        r = tu.tree_map(lambda ri, api: ri - alpha * api, r, ap)
        rs_new = _vdot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = tu.tree_map(lambda ri, pi: ri + beta * pi, r, p)
        rs = rs_new
    return _neg(mixed_vjp(spec, theta, lam, base_batch, x))


# ---------------------------------------------------------------------------
# T1-T2 / DARTS one-step [Luketina et al. 2016; Liu et al. 2019]
# ---------------------------------------------------------------------------


def t1t2_hypergrad(spec: BilevelSpec, theta, lam, base_batch, meta_batch):
    """Identity base-Jacobian, *no* optimizer adaptation, exact mixed VJP.
    (SAMA-NA with central difference replaced by the exact second-order
    product: the classical formulation.)"""

    g_meta = _meta_grad(spec, theta, lam, meta_batch)
    return _neg(mixed_vjp(spec, theta, lam, base_batch, g_meta))


# ---------------------------------------------------------------------------
# Iterative differentiation [MAML-style unrolled]
# ---------------------------------------------------------------------------


def iterdiff_hypergrad(
    spec: BilevelSpec, theta, lam, base_batches, meta_batch,
    *, base_opt: Optimizer,
):
    """Differentiate through K unrolled optimizer steps from a fresh
    optimizer state. ``base_batches`` is a tree with a leading unroll axis.
    Memory grows with K: the point the paper makes against iterative
    differentiation."""

    # The meta loss and its backward stay inside the context too: that
    # backward reaches through the re-unroll's remat layers, whose recompute
    # must take the route their forward took (torch.utils.checkpoint raises
    # when the saved tensors differ), and a remat layer of the meta loss
    # would recompute plain in that same backward.
    #
    # Under the global-batch reducer the unroll is not linear in the batch:
    # each base gradient is averaged inside the graph (sync.mean_graph) and
    # the replicated theta and lam enter each shard's loss through
    # sync.enter, whose backward averages the shards' cotangents, so lam's
    # gradient comes out global; outside it both are the identity.
    with dispatch.second_order():
        lm_live, lam_live, lam_paths = _live(lam)
        with torch.enable_grad():
            lm = sync.enter(lm_live)
            th = tu.tree_map(lambda x: x.detach().requires_grad_(True), theta)
            state = base_opt.init(theta)
            for i in range(tu.tree_leaves(base_batches)[0].shape[0]):
                batch = tu.tree_map(lambda x: x[i], base_batches)
                th_in = sync.enter(th)
                leaves, paths = tu.tree_flatten(th_in)
                g = _raw_grad(spec.base_scalar(th_in, lm, batch), leaves, create_graph=True)
                g = sync.mean_graph(tu.tree_unflatten(paths, g))
                upd, state = base_opt.update(g, state, th)
                th = apply_updates(th, upd)
            meta = spec.meta_scalar(sync.enter(th), lm, meta_batch)
        return tu.tree_unflatten(lam_paths, _raw_grad(meta, lam_live))


HYPERGRAD_BASELINES = {
    "neumann": neumann_hypergrad,
    "cg": cg_hypergrad,
    "t1t2": t1t2_hypergrad,
    "iterdiff": iterdiff_hypergrad,
}
