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

Under a live model axis (``launch.fsdp``) a model group shares one
estimate of its data shard. The sharded loss makes every gradient above
the group's already: the gather that feeds it the whole parameters sums
the blocks' gradients over the group in its backward, and the loss is the
group's mean. What the loss cannot do is a plain value over a tree of
this rank's blocks: a norm or a dot product. :func:`leaf_sum` adds each
sharded leaf's partial over the model group and each replicated leaf's
once (``global_norm``, the fused adaptation products' sums of squares,
CG's dot products), and :func:`all_true` makes a finiteness gate the
group's. A reduction over one dim of a leaf that the layout splits
(Adafactor's row and column statistics) takes :func:`group_sum` of the
block's partial sum, over :func:`sharded_dims`. Outside :func:`sharded`
all of them are the plain reductions.
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


#: the FSDP layouts of the steps that run, innermost last (None: a step
#: with no model axis)
_SHARDED: List[Any] = []


@contextlib.contextmanager
def sharded(layout):
    """Within the block :func:`leaf_sum` and :func:`all_true` reduce over
    ``layout``'s model group (a ``launch.fsdp.FSDP``, or None: plainly)."""

    _SHARDED.append(layout)
    try:
        yield layout
    finally:
        _SHARDED.pop()


def leaf_sum(tree: Tree, partials: List[Any]):
    """The sum of ``partials``, one 0-d tensor per leaf of ``tree`` (in
    ``tree.flatten_with_keys`` order), over the whole parameters: under a
    live model axis the partials of the leaves the layout shards (this
    rank's blocks: the leaf's name and block shape) are summed over the
    model group, and each replicated leaf's is counted once. Plainly the
    left-to-right sum."""

    layout = _SHARDED[-1] if _SHARDED else None
    if layout is None:
        total = partials[0]
        for p in partials[1:]:
            total = total + p
        return total
    return layout.leaf_sum(tree, partials)


def all_true(flag):
    """A 0-d bool gate, the model group's AND under a live model axis."""
    layout = _SHARDED[-1] if _SHARDED else None
    return flag if layout is None else layout.all_true(flag)


def sharded_dims(tree: Tree) -> List[Any]:
    """Per leaf of ``tree`` (a theta-like tree of this rank's blocks, in
    ``tree.flatten_with_keys`` order): the dim the layout shards over the
    model group under a live model axis, None for a replicated leaf; None
    for every leaf plainly."""

    layout = _SHARDED[-1] if _SHARDED else None
    if layout is None:
        from repro_torch import tree as tu

        return [None] * len(tu.tree_leaves(tree))
    return layout.sharded_dims(tree)


def model_extent() -> int:
    """The model group's extent under a live model axis, else 1."""
    layout = _SHARDED[-1] if _SHARDED else None
    return 1 if layout is None else layout.mesh.model_size


def group_sum(x):
    """A partial of this rank's block summed over the model group under a
    live model axis (differentiable: its backward sums the cotangents
    over the group); plainly ``x``."""
    layout = _SHARDED[-1] if _SHARDED else None
    return x if layout is None else layout.group_sum(x)


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
