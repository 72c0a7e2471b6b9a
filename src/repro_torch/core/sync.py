"""The gradient chokepoints' reduce, for the global-batch (pjit) schedule.

On a mesh, JAX's partitioner turns the Engine step over a sharded batch
into the step over the global batch: every gradient of a batch-mean loss
is reduced over the data shards wherever the step takes it. The port
keeps that rule in the few places that take gradients, which read the
reducer of the step that runs (:func:`reducing`), so no method carries a
collective of its own:

* ``core.sama.value_and_grad`` (and ``scaled_value_and_grad`` through it):
  the base gradients, the meta pass's theta-gradient, the central
  differences' lam-gradients, the baselines' meta gradient;
* ``core.baselines._grad``, first order: the Hessian-vector and mixed
  products (linear in the batch, so the mean of the shards' products is
  the global one);
* ``scale.accum.accumulated_value_and_grad``: once, on the sum over M
  microbatches;
* iterative differentiation's re-unroll, whose chain of gradients is not
  linear in the batch: there ``enter`` marks where replicated values
  enter a shard's loss (identity forward, mean over shards in the
  backward) and ``mean_graph`` reduces a gradient that stays in the
  graph (mean forward, identity backward), which together give the
  global-batch derivative.

Outside :func:`reducing` (the Engine step, the single-sync schedule) every
function here is the identity.
"""

from __future__ import annotations

import contextlib
from typing import Any, List

Tree = Any

#: the reducers of the steps that run, innermost last; a plain list, not a
#: context variable, since autograd may run a backward on its own threads
_ACTIVE: List[Any] = []


@contextlib.contextmanager
def reducing(reducer):
    """Within the block every chokepoint reduces through ``reducer``, an
    object with ``mean(tree)``, ``enter(tree)`` and ``mean_graph(tree)``."""

    _ACTIVE.append(reducer)
    try:
        yield reducer
    finally:
        _ACTIVE.pop()


def active():
    """The innermost reducer, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def mean(tree: Tree) -> Tree:
    """A gradient tree of a shard's batch-mean loss as the global one."""
    r = active()
    return tree if r is None else r.mean(tree)


def enter(tree: Tree) -> Tree:
    """Replicated values as a shard's loss reads them (identity forward;
    the backward averages the shards' cotangents)."""
    r = active()
    return tree if r is None else r.enter(tree)


def mean_graph(tree: Tree) -> Tree:
    """:func:`mean` for a gradient that stays in the graph (identity
    backward)."""
    r = active()
    return tree if r is None else r.mean_graph(tree)
