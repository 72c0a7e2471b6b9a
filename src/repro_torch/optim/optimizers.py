"""Tree optimizers with analytic adaptation matrices, after
``src/repro/optim/optimizers.py``.

The update convention follows the paper (Sec. 2, Eq. 2):

    theta_t = theta_{t-1} - u(g_t; state)

``Optimizer.update`` returns the step ``u`` (to be subtracted) and the new
state. ``Optimizer.adaptation`` returns the diagonal of ``du/dg`` at the
same (g, state) point: SAMA's algorithmic adaptation (paper Sec. 3.2,
Appendix C). For the elementwise optimizers (sgd, momentum, adam, adamw,
rmsprop) that diagonal is exact; lion and adafactor declare surrogates in
their docstrings (sign smoothing, frozen factored statistics), because
their exact derivatives are degenerate or not diagonal.
``Optimizer.adapt_product`` is the fused path SAMA's meta step takes:
``(grads, state, params, g_meta) -> (v, sum(v**2))`` with
``v = diag(du/dg) * g_meta`` per leaf through the optimizer's kernel
(``adam_adapt``, ``lion_adapt``, ``adafactor_adapt``), the sum of squares
coming out of the same pass. Optimizers without one leave it None, and
SAMA takes ``adaptation``, the product and a separate norm.

Parameters and states are nested dicts of tensors; the step count is a
0-d int32 tensor on the parameters' device. Adafactor's second-moment
leaves are dicts one level below the parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.kernels import adafactor_adapt as adafactor_adapt_mod
from repro_torch.kernels import adam_adapt as adam_adapt_mod
from repro_torch.kernels import lion_adapt as lion_adapt_mod
from repro_torch.optim import schedules

Tree = Any

#: type of the fused adaptation-product hook:
#: (grads, state, params, g_meta) -> (v tree, sum(v^2) scalar)
AdaptProduct = Callable[[Tree, "OptState", Tree, Tree], Tuple[Tree, torch.Tensor]]


class OptState(NamedTuple):
    count: torch.Tensor  # 0-d int32 step counter (post-increment convention)
    mu: Optional[Tree] = None  # first moment / momentum
    nu: Optional[Tree] = None  # second moment (adafactor: factored dicts)


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
    from repro_torch.core import sync  # core imports this package

    # under a live model axis the blocks' sums add over the model group
    return tree, sync.leaf_sum(grads, sumsqs)


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


def rmsprop(
    lr: schedules.ScalarOrSchedule,
    rho: float = 0.99,
    eps: float = 1e-8,
) -> Optimizer:
    """v' = rho v + (1-rho) g^2 ; u = lr g / (sqrt(v') + eps).

    Adaptation: the exact elementwise diagonal at (g, nu),

        du/dg = lr * [ 1/denom - g^2 (1-rho) / (sqrt(v') * denom^2) ],
        denom = sqrt(v') + eps,

    in torch ops (the JAX package has no kernel for it either)."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        return OptState(count=_count(params), nu=_zeros_like(params))

    def update(grads, state, params):
        del params
        step_lr = lr_fn(state.count)
        nu = tu.tree_map(lambda v, g: rho * v + (1.0 - rho) * g * g, state.nu, grads)
        step = tu.tree_map(lambda g, v: step_lr * g / (torch.sqrt(v) + eps), grads, nu)
        return step, OptState(count=state.count + 1, nu=nu)

    def adaptation(grads, state, params):
        del params
        step_lr = lr_fn(state.count)

        def one(g, v):
            v1 = rho * v + (1.0 - rho) * g * g
            sq = torch.sqrt(v1)
            denom = sq + eps
            safe_sq = torch.clamp_min(sq, 1e-15)
            return step_lr * (1.0 / denom - g * (1.0 - rho) * g / (safe_sq * denom * denom))

        return tu.tree_map(one, grads, state.nu)

    return Optimizer("rmsprop", init, update, adaptation)


# ---------------------------------------------------------------------------
# Lion (sign momentum): surrogate adaptation
# ---------------------------------------------------------------------------


def lion(
    lr: schedules.ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.0,
    adapt_delta: float = 1e-3,
) -> Optimizer:
    """Lion (Chen et al., Symbolic Discovery of Optimization Algorithms):

        c  = b1 m + (1-b1) g          (update interpolation)
        u  = lr (sign(c) + wd p)      (decoupled decay)
        m' = b2 m + (1-b2) g

    Adaptation: the derivative of ``sign`` is zero almost everywhere, which
    would turn SAMA into SAMA-NA. ``adaptation`` declares the smoothed
    surrogate ``sign_d(c) = c / (|c| + delta)`` instead and returns its
    elementwise diagonal at (g, mu), ``delta = adapt_delta``:

        du/dg = lr (1-b1) delta / (|c| + delta)^2,

    through the ``lion_adapt`` kernel for both ``adaptation`` and the
    fused ``adapt_product``."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        return OptState(count=_count(params), mu=_zeros_like(params))

    def update(grads, state, params):
        step_lr = lr_fn(state.count)

        def one(m, g, p):
            c = b1 * m + (1.0 - b1) * g
            step = step_lr * torch.sign(c)
            if weight_decay:
                step = step + step_lr * weight_decay * p
            return step

        step = tu.tree_map(one, state.mu, grads, params)
        mu = tu.tree_map(lambda m, g: b2 * m + (1.0 - b2) * g, state.mu, grads)
        return step, OptState(count=state.count + 1, mu=mu)

    def _kernel_call(state):
        step_lr = lr_fn(state.count)

        def call(g, m, gm):
            return lion_adapt_mod.lion_adapt(g, m, gm, lr=step_lr, b1=b1, delta=adapt_delta)

        return call

    def adaptation(grads, state, params):
        del params
        call = _kernel_call(state)

        def one(g, m):
            out, _ = call(g.reshape(-1), m.reshape(-1), torch.ones_like(g.reshape(-1)))
            return out.reshape(g.shape)

        return tu.tree_map(one, grads, state.mu)

    def adapt_product(grads, state, params, g_meta):
        del params
        return _fused_product(_kernel_call(state), grads, state.mu, g_meta)

    return Optimizer("lion", init, update, adaptation, adapt_product)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment): frozen-statistics adaptation
# ---------------------------------------------------------------------------


def _mean(x, dim: int, split: bool):
    """``torch.mean(x, dim)``; where ``dim`` is split over the model group
    (``x`` this rank's block of it), the group's sum over the whole extent
    (``core.sync``)."""
    if not split:
        return torch.mean(x, dim=dim)
    from repro_torch.core import sync  # core imports this package

    return sync.group_sum(torch.sum(x, dim=dim)) / (x.shape[dim] * sync.model_extent())


def _adafactor_stats(g, nu_leaf, t, b2, eps1, sharded_dim=None):
    """Advance one leaf's (factored) second-moment statistics and return
    (new nu leaf, bias-corrected vhat). 2-D leaves keep row and column
    means (O(r + c) state); every other shape keeps the full moment.
    ``sharded_dim``: the dim of a 2-D leaf split over a live model axis,
    whose means then sum over the model group."""

    g2 = g * g + eps1
    # bias correction in at least f32 (see adam): 1 - b2^t rounds to 0 in bf16
    bc2 = (1.0 - b2 ** t.to(torch.promote_types(g.dtype, torch.float32))).to(g.dtype)
    if "r" in nu_leaf:
        r1 = b2 * nu_leaf["r"] + (1.0 - b2) * _mean(g2, 1, sharded_dim == 1)
        c1 = b2 * nu_leaf["c"] + (1.0 - b2) * _mean(g2, 0, sharded_dim == 0)
        rhat = r1 / bc2
        chat = c1 / bc2
        norm = torch.mean(rhat) if sharded_dim != 0 else _mean(rhat, 0, True)
        vhat = rhat[:, None] * chat[None, :] / norm
        return {"r": r1, "c": c1}, vhat
    v1 = b2 * nu_leaf["v"] + (1.0 - b2) * g2
    return {"v": v1}, v1 / bc2


def _adafactor_map(fn, grads, nu):
    """``fn(g, nu_leaf)`` over the parameter leaves, ``nu``'s leaves being
    the per-parameter statistics dicts one level below. Returns (the key
    paths, the results)."""

    leaves, paths = tu.tree_flatten(grads)
    return paths, [fn(g, n) for g, n in zip(leaves, tu.tree_flatten_up_to(paths, nu))]


def adafactor(
    lr: schedules.ScalarOrSchedule,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps1: float = 1e-30,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adafactor (Shazeer & Stern), reduced to its memory-factored core:
    2-D parameters keep row and column mean second-moment statistics,
    rebuilt as the rank-1 ``vhat = rhat (x) chat / mean(rhat)``; other
    shapes keep the full moment. Adam-style bias correction and a fixed
    ``b2`` take the place of the original's relative step sizes and update
    clipping.

        u = lr g / (sqrt(vhat) + eps)   (+ lr wd p, decoupled)

    Adaptation: the factored statistics couple whole rows and columns, so
    the exact du/dg is not diagonal. ``adaptation`` declares the
    frozen-statistics diagonal

        du/dg = lr / (sqrt(vhat) + eps),

    exact as b2 -> 1, and both it and the fused ``adapt_product`` send the
    elementwise tail through the ``adafactor_adapt`` kernel after the
    rank-1 ``vhat`` is rebuilt in torch. Under a live model axis
    (``launch.fsdp``) each mean over a sharded dim is the model group's,
    in ``update`` and in both adaptations alike."""

    lr_fn = schedules.resolve(lr)

    def init(params):
        def one(p):
            if p.dim() == 2:
                return {"r": torch.zeros((p.shape[0],), dtype=p.dtype, device=p.device),
                        "c": torch.zeros((p.shape[1],), dtype=p.dtype, device=p.device)}
            return {"v": torch.zeros_like(p)}

        return OptState(count=_count(params), nu=tu.tree_map(one, params))

    def _stats(grads, state):
        from repro_torch.core import sync  # core imports this package

        dims = iter(sync.sharded_dims(grads))

        def one(g, nu_leaf):
            return _adafactor_stats(g, nu_leaf, (state.count + 1).to(g.dtype), b2, eps1,
                                    next(dims))

        return _adafactor_map(one, grads, state.nu)

    def update(grads, state, params):
        step_lr = lr_fn(state.count)
        paths, pairs = _stats(grads, state)
        steps = []
        for (_, vhat), g, p in zip(pairs, tu.tree_leaves(grads), tu.tree_leaves(params)):
            step = step_lr * g / (torch.sqrt(vhat) + eps)
            if weight_decay:
                step = step + step_lr * weight_decay * p
            steps.append(step)
        nu = tu.tree_unflatten(paths, [n for n, _ in pairs])
        return tu.tree_unflatten(paths, steps), OptState(count=state.count + 1, nu=nu)

    def adaptation(grads, state, params):
        del params
        step_lr = lr_fn(state.count)
        paths, pairs = _stats(grads, state)
        outs = []
        for _, vhat in pairs:
            out, _ = adafactor_adapt_mod.adafactor_adapt(
                vhat.reshape(-1), torch.ones_like(vhat.reshape(-1)), lr=step_lr, eps=eps)
            outs.append(out.reshape(vhat.shape))
        return tu.tree_unflatten(paths, outs)

    def adapt_product(grads, state, params, g_meta):
        del params
        step_lr = lr_fn(state.count)
        paths, pairs = _stats(grads, state)
        outs, sumsqs = [], []
        for (_, vhat), gm in zip(pairs, tu.tree_leaves(g_meta)):
            out, ss = adafactor_adapt_mod.adafactor_adapt(vhat.reshape(-1), gm.reshape(-1),
                                                          lr=step_lr, eps=eps)
            outs.append(out.reshape(vhat.shape))
            sumsqs.append(ss)
        from repro_torch.core import sync  # core imports this package

        # under a live model axis the blocks' sums add over the model group
        return tu.tree_unflatten(paths, outs), sync.leaf_sum(grads, sumsqs)

    return Optimizer("adafactor", init, update, adaptation, adapt_product)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FACTORIES = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adamw": adamw,
    "rmsprop": rmsprop,
    "lion": lion,
    "adafactor": adafactor,
}


def get_optimizer(name: str, lr: schedules.ScalarOrSchedule, **kwargs) -> Optimizer:
    if name not in _FACTORIES:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](lr, **kwargs)
