"""Tree optimizers with analytic adaptation matrices, after
``src/repro/optim/optimizers.py``.

The update convention follows the paper (Sec. 2, Eq. 2):

    theta_t = theta_{t-1} - u(g_t; state)

``Optimizer.update`` returns the step ``u`` (to be subtracted) and the new
state. ``Optimizer.adaptation`` returns the diagonal of ``du/dg`` at the
same (g, state) point: SAMA's algorithmic adaptation (paper Sec. 3.2,
Appendix C). ``Optimizer.adapt_product`` is the fused path SAMA's meta step
takes: ``(grads, state, params, g_meta) -> (v, sum(v**2))`` with
``v = diag(du/dg) * g_meta`` per leaf through the ``adam_adapt`` kernel,
the sum of squares coming out of the same pass.

Parameters and states are nested dicts of tensors; the step count is a
0-d int32 tensor on the parameters' device. ``lion`` and ``adafactor``
come with their kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.kernels import adam_adapt as adam_adapt_mod
from repro_torch.optim import schedules

Tree = Any

#: type of the fused adaptation-product hook:
#: (grads, state, params, g_meta) -> (v tree, sum(v^2) scalar)
AdaptProduct = Callable[[Tree, "OptState", Tree, Tree], Tuple[Tree, torch.Tensor]]


class OptState(NamedTuple):
    count: torch.Tensor  # 0-d int32 step counter (post-increment convention)
    mu: Optional[Tree] = None  # first moment / momentum
    nu: Optional[Tree] = None  # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A base-level iterative solver ``u`` with its analytic ``du/dg``."""

    name: str
    init: Callable[[Tree], OptState]
    # (grads, state, params) -> (step_u, new_state)
    update: Callable[[Tree, OptState, Tree], Tuple[Tree, OptState]]
    # (grads, state, params) -> diagonal of du/dg, same structure as params
    adaptation: Callable[[Tree, OptState, Tree], Tree]
    # optional fused (diag * g_meta, sumsq) fast path (kernel-dispatched)
    adapt_product: Optional[AdaptProduct] = None


def apply_updates(params: Tree, step: Tree) -> Tree:
    """theta' = theta - u."""
    return tu.tree_map(lambda p, s: (p - s).to(p.dtype), params, step)


def _zeros_like(params):
    return tu.tree_map(torch.zeros_like, params)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tu.tree_leaves(params)[0].device)


def _fused_product(kernel_call, grads, *stat_trees):
    """Run a flat fused-product kernel leaf by leaf, adding the per-leaf
    sums of squares into one scalar. ``kernel_call(g_flat, *stats_flat) ->
    (out_flat, sumsq)``; returns (tree like grads, total)."""

    sumsqs = []

    def one(g, *stats):
        out, ss = kernel_call(g.reshape(-1), *(s.reshape(-1) for s in stats))
        sumsqs.append(ss)
        return out.reshape(g.shape)

    tree = tu.tree_map(one, grads, *stat_trees)
    total = sumsqs[0]
    for ss in sumsqs[1:]:
        total = total + ss
    return tree, total


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------


def sgd(lr: schedules.ScalarOrSchedule, weight_decay: float = 0.0) -> Optimizer:
    """u = lr * (g + wd * theta). du/dg = lr * I exactly, at any state."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        return OptState(count=_count(params))

    def update(grads, state, params):
        step_lr = lr_fn(state.count)
        if weight_decay:
            step = tu.tree_map(lambda g, p: step_lr * (g + weight_decay * p), grads, params)
        else:
            step = tu.tree_map(lambda g: step_lr * g, grads)
        return step, OptState(count=state.count + 1)

    def adaptation(grads, state, params):
        step_lr = lr_fn(state.count)
        return tu.tree_map(lambda g: torch.ones_like(g) * step_lr, grads)

    return Optimizer("sgd", init, update, adaptation)


def momentum(
    lr: schedules.ScalarOrSchedule, beta: float = 0.9, weight_decay: float = 0.0
) -> Optimizer:
    """Heavy-ball: m' = beta m + g_eff; u = lr m'. du/dg = lr * I exactly."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        return OptState(count=_count(params), mu=_zeros_like(params))

    def _geff(grads, params):
        if weight_decay:
            return tu.tree_map(lambda g, p: g + weight_decay * p, grads, params)
        return grads

    def update(grads, state, params):
        geff = _geff(grads, params)
        mu = tu.tree_map(lambda m, g: beta * m + g, state.mu, geff)
        step_lr = lr_fn(state.count)
        step = tu.tree_map(lambda m: step_lr * m, mu)
        return step, OptState(count=state.count + 1, mu=mu)

    def adaptation(grads, state, params):
        step_lr = lr_fn(state.count)
        return tu.tree_map(lambda g: torch.ones_like(g) * step_lr, grads)

    return Optimizer("momentum", init, update, adaptation)


# ---------------------------------------------------------------------------
# Adam family (paper Appendix C)
# ---------------------------------------------------------------------------


def adam(
    lr: schedules.ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adam; ``weight_decay`` is decoupled (AdamW-style), so the adaptation
    matrix does not see it.

    Adaptation: the exact elementwise diagonal of du/dg at (g, mu, nu,
    count), paper Appendix C without the eps << 1 approximation,

        du/dg = lr * [ a/denom - mhat * b * g / (sqrt(vhat) * denom^2) ],
        a = (1-b1)/bc1,  b = (1-b2)/bc2,  denom = sqrt(vhat) + eps,

    through the ``adam_adapt`` kernel for both ``adaptation`` and the
    fused ``adapt_product``."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        return OptState(count=_count(params), mu=_zeros_like(params), nu=_zeros_like(params))

    def update(grads, state, params):
        step_lr = lr_fn(state.count)
        mu = tu.tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
        nu = tu.tree_map(lambda v, g: b2 * v + (1.0 - b2) * g * g, state.nu, grads)

        def one(m1, v1, g, p):
            # bias corrections in at-least-f32: in bf16, 1 - 0.999^t rounds
            # to 0 (8 mantissa bits), making vhat 0/0 on zero-gradient
            # coordinates; f32 paths are unchanged by it
            t = (state.count + 1).to(torch.promote_types(g.dtype, torch.float32))
            bc1 = (1.0 - b1 ** t).to(g.dtype)
            bc2 = (1.0 - b2 ** t).to(g.dtype)
            mhat = m1 / bc1
            vhat = v1 / bc2
            step = step_lr * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                step = step + step_lr * weight_decay * p
            return step

        step = tu.tree_map(one, mu, nu, grads, params)
        return step, OptState(count=state.count + 1, mu=mu, nu=nu)

    def _kernel_call(state):
        step_lr = lr_fn(state.count)
        t = state.count + 1

        def call(g, m, v, gm):
            return adam_adapt_mod.adam_adapt(g, m, v, gm, t=t, b1=b1, b2=b2, eps=eps,
                                             lr=step_lr)

        return call

    def adaptation(grads, state, params):
        del params  # decoupled wd: no g dependence
        call = _kernel_call(state)

        def one(g, m, v):
            out, _ = call(g.reshape(-1), m.reshape(-1), v.reshape(-1),
                          torch.ones_like(g.reshape(-1)))
            return out.reshape(g.shape)

        return tu.tree_map(one, grads, state.mu, state.nu)

    def adapt_product(grads, state, params, g_meta):
        del params
        return _fused_product(_kernel_call(state), grads, state.mu, state.nu, g_meta)

    return Optimizer("adam", init, update, adaptation, adapt_product)


def adamw(
    lr: schedules.ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> Optimizer:
    """Adam with decoupled weight decay on by default; the same adaptation
    (and ``adam_adapt`` route) as ``adam``."""

    opt = adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return dataclasses.replace(opt, name="adamw")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FACTORIES = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
}


def get_optimizer(name: str, lr: schedules.ScalarOrSchedule, **kwargs) -> Optimizer:
    if name not in _FACTORIES:
        raise ValueError(f"unknown or not yet ported optimizer {name!r}; have "
                         f"{sorted(_FACTORIES)}")
    return _FACTORIES[name](lr, **kwargs)
