"""Carries parameter trees between the JAX package and the port.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so the two packages compute the same thing only on the same
weights: the JAX side exports its tree as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) and the port takes it
here. The trees have the same nested-dict structure and stacked layer
axes on both sides, so leaves map one to one. The same functions carry
decode caches, and ``state_from_jax`` / ``state_to_numpy`` carry a whole
training state (theta, lam, both optimizers' moments and counts, the
step) so that both packages can start from one state; moments that are
nested one level below the parameter tree, as Adafactor's ``{"r", "c"}``
and ``{"v"}`` statistics, cross as nested dicts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.models import common as cm
from repro_torch.optim import OptState

Tree = Any


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=torch.bfloat16)
    # a copy: JAX's buffers are read-only, and the port writes caches in place
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Tree, *, device="cuda") -> Tree:
    """A nested dict of numpy arrays (a JAX tree after ``np.asarray``) as a
    nested dict of tensors on ``device``, dtypes kept."""

    device = cm.resolve_device(device)
    return cm.tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Tree) -> Tree:
    """The inverse: tensors to numpy (bf16 leaves come back as f32, which
    holds them exactly)."""

    def to_np(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return cm.tree_map(to_np, tree)


def _opt_state_from_jax(st, device) -> OptState:
    def conv(tree):
        return None if tree is None else cm.tree_map(lambda a: _to_tensor(a, device), tree)

    return OptState(count=_to_tensor(st.count, device), mu=conv(st.mu), nu=conv(st.nu))


def state_from_jax(state, *, device="cuda") -> EngineState:
    """A JAX ``EngineState`` (its leaves as numpy, ``jax.tree_util.tree_map(
    np.asarray, state)``) as the port's, on ``device``. Read by field name:
    theta, base_opt_state and meta_opt_state (``OptState`` count, mu, nu),
    lam, step. The JAX state's loss-scale field has no counterpart yet
    (only the identity scale policy is ported) and must be None."""

    if getattr(state, "scale", None) is not None:
        raise ValueError("a loss-scaled JAX state has no counterpart in the port yet")
    device = cm.resolve_device(device)
    return EngineState(
        theta=params_from_jax(state.theta, device=device),
        base_opt_state=_opt_state_from_jax(state.base_opt_state, device),
        lam=params_from_jax(state.lam, device=device),
        meta_opt_state=_opt_state_from_jax(state.meta_opt_state, device),
        step=_to_tensor(state.step, device),
    )


def state_to_numpy(state: EngineState) -> EngineState:
    """The inverse: the port's EngineState with numpy leaves (field names
    as JAX's, so ``repro.core.EngineState(**state._asdict())`` rebuilds
    the JAX state)."""

    def opt(st: OptState) -> OptState:
        return OptState(count=params_to_numpy(st.count),
                        mu=None if st.mu is None else params_to_numpy(st.mu),
                        nu=None if st.nu is None else params_to_numpy(st.nu))

    return EngineState(theta=params_to_numpy(state.theta),
                       base_opt_state=opt(state.base_opt_state),
                       lam=params_to_numpy(state.lam),
                       meta_opt_state=opt(state.meta_opt_state),
                       step=params_to_numpy(state.step))
