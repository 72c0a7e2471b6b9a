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



def flatten_with_keys(tree: Tree) -> Tuple[List[str], List[Any]]:
    """Leaf names and leaves of a tree of NamedTuples, dicts, tuples and
    lists, the names as ``jax.tree_util.keystr`` renders their paths and in
    JAX's leaf order: NamedTuple fields ``.name`` in declared order, dict
    keys ``['key']`` sorted, sequence items ``[i]``; ``None`` is an empty
    subtree (Adafactor's ``mu``, a stateless optimizer's moments)."""

    names: List[str] = []
    leaves: List[Any] = []

    def rec(node, name):
        if node is None:
            return
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for field in node._fields:
                rec(getattr(node, field), f"{name}.{field}")
        elif isinstance(node, dict):
            for key in sorted(node):
                rec(node[key], f"{name}[{key!r}]")
        elif isinstance(node, (tuple, list)):
            for i, item in enumerate(node):
                rec(item, f"{name}[{i}]")
        else:
            names.append(name)
            leaves.append(node)

    rec(tree, "")
    return names, leaves


def unflatten_like(like: Tree, leaves: Sequence[Any]) -> Tree:
    """``like``'s structure with its leaves replaced, in
    :func:`flatten_with_keys` order, by ``leaves``."""

    it = iter(leaves)

    def rec(node):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(getattr(node, f)) for f in node._fields))
        if isinstance(node, dict):
            return {key: rec(node[key]) for key in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(rec(item) for item in node)
        return next(it)

    out = rec(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
