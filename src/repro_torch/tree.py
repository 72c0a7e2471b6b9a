"""Trees of tensors: the port's counterpart of ``jax.tree_util``.
Parameters are nested dicts, whose leaves come in sorted-key order (JAX's
order for dicts) with their key paths as the tree structure
(``tree_flatten``); whole states are NamedTuples, tuples and lists around
them (``flatten_with_keys``). ``tree_map`` walks both.

The walks recurse through module-level functions: a nested function that
calls itself is a reference cycle, which would keep the lists of leaves it
closes over, and so every tensor of a spent tree, alive until Python's
cycle collector happens to run: on the card, parameter-sized trees past
their last use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

Tree = Any


def tree_flatten(tree: Tree) -> Tuple[List[Any], Tuple[Tuple[str, ...], ...]]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts) and their key paths, which serve as the treedef."""

    paths: List[Tuple[str, ...]] = []
    leaves: List[Any] = []
    _flatten_dicts(tree, (), paths, leaves)
    return leaves, tuple(paths)


def _flatten_dicts(node, path, paths, leaves):
    if isinstance(node, dict):
        for key in sorted(node):
            _flatten_dicts(node[key], path + (key,), paths, leaves)
    else:
        paths.append(path)
        leaves.append(node)


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
    which must name the same leaves (``jax.tree_util.tree_map``). One walk
    for every tree the port maps: nested dicts of parameters, and whole
    states of NamedTuples, tuples and lists (``None`` an empty subtree),
    in :func:`flatten_with_keys` order."""

    names, leaves = flatten_with_keys(tree)
    others = []
    for other in rest:
        o_names, o_leaves = flatten_with_keys(other)
        if o_names != names:
            raise ValueError(f"tree structures differ: {names} vs {o_names}")
        others.append(o_leaves)
    return unflatten_like(tree, [fn(*xs) for xs in zip(leaves, *others)])


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
    _flatten_keyed(tree, "", names, leaves)
    return names, leaves


def _flatten_keyed(node, name, names, leaves):
    if node is None:
        return
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for field in node._fields:
            _flatten_keyed(getattr(node, field), f"{name}.{field}", names, leaves)
    elif isinstance(node, dict):
        for key in sorted(node):
            _flatten_keyed(node[key], f"{name}[{key!r}]", names, leaves)
    elif isinstance(node, (tuple, list)):
        for i, item in enumerate(node):
            _flatten_keyed(item, f"{name}[{i}]", names, leaves)
    else:
        names.append(name)
        leaves.append(node)


def unflatten_like(like: Tree, leaves: Sequence[Any]) -> Tree:
    """``like``'s structure with its leaves replaced, in
    :func:`flatten_with_keys` order, by ``leaves``."""

    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(node, it):
    if node is None:
        return None
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, f), it) for f in node._fields))
    if isinstance(node, dict):
        return {key: _rebuild(node[key], it) for key in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_rebuild(item, it) for item in node)
    return next(it)
