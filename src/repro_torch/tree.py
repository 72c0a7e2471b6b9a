"""Nested dicts of tensors as trees: the port's counterpart of
``jax.tree_util``. Leaves come in sorted-key order (JAX's order for
dicts), and the key paths serve as the tree structure.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Tree = Any


def tree_flatten(tree: Tree) -> Tuple[List[Any], Tuple[Tuple[str, ...], ...]]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts) and their key paths, which serve as the treedef."""

    paths: List[Tuple[str, ...]] = []
    leaves: List[Any] = []

    def rec(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                rec(node[key], path + (key,))
        else:
            paths.append(path)
            leaves.append(node)

    rec(tree, ())
    return leaves, tuple(paths)


def tree_unflatten(paths: Sequence[Tuple[str, ...]], leaves: Sequence[Any]) -> Tree:
    if tuple(paths) == ((),):  # a bare leaf
        return leaves[0]
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must have the same structure (``jax.tree_util.tree_map``)."""
    leaves, paths = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_paths = tree_flatten(other)
        if o_paths != paths:
            raise ValueError(f"tree structures differ: {paths} vs {o_paths}")
        others.append(o_leaves)
    return tree_unflatten(paths, [fn(*xs) for xs in zip(leaves, *others)])


def tree_flatten_up_to(paths: Sequence[Tuple[str, ...]], tree: Tree) -> List[Any]:
    """The subtrees of ``tree`` at ``paths`` (the key paths of a shallower
    tree): ``treedef.flatten_up_to``, for a state whose leaves sit one
    level deeper than the parameters, as Adafactor's ``{"r", "c"}`` and
    ``{"v"}`` statistics do."""
    out = []
    for path in paths:
        node = tree
        for key in path:
            node = node[key]
        out.append(node)
    return out

