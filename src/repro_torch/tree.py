"""Nested containers of tensors: the parameter dict, ``OptState``, and the
``(params, opt)`` pair a checkpoint holds.

One walk serves all of them.  Dicts are walked by key in insertion
order, NamedTuples by field, tuples and lists by index; anything else is
a leaf.  A leaf's path joins its keys with ``/``.  These are the keys of
the reference's checkpoint format, e.g. ``1/mu/layers/ln1`` for
``(params, OptState)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

PyTree = Any
SEP = "/"


def _keys(node: PyTree) -> Optional[list]:
    """The keys of a container, or None for a leaf."""
    if isinstance(node, dict):
        return list(node)
    if hasattr(node, "_fields"):          # NamedTuple (before tuple)
        return list(node._fields)
    if isinstance(node, (tuple, list)):
        return list(range(len(node)))
    return None


def _child(node: PyTree, key) -> PyTree:
    return getattr(node, key) if hasattr(node, "_fields") else node[key]


def _build(like: PyTree, keys: list, values: list) -> PyTree:
    if isinstance(like, dict):
        return dict(zip(keys, values))
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       is_leaf: Optional[Callable[[Any], bool]] = None,
                       path: str = "") -> PyTree:
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` (and of
    ``rest``, which share its structure), in ``tree``'s structure.  A node
    for which ``is_leaf`` is true counts as a leaf."""
    keys = None if is_leaf is not None and is_leaf(tree) else _keys(tree)
    if keys is None:
        return fn(path, tree, *rest)
    return _build(tree, keys, [
        tree_map_with_path(fn, _child(tree, k),
                           *(_child(r, k) for r in rest), is_leaf=is_leaf,
                           path=f"{path}{SEP}{k}" if path else str(k))
        for k in keys])


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn(leaf, *rest_leaves)`` over the leaves, in ``tree``'s
    structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest,
                              is_leaf=is_leaf)


def tree_flatten_with_paths(tree: PyTree) -> Dict[str, Any]:
    """``{path: leaf}`` in walk order."""
    out: Dict[str, Any] = {}
    tree_map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves in walk order."""
    return list(tree_flatten_with_paths(tree).values())


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order) in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_unzip(tree: PyTree, n: int) -> tuple:
    """``n`` trees from one whose leaves are ``n``-tuples: the ``i``-th
    holds element ``i`` of every leaf."""
    def is_tuple(x):
        return type(x) is tuple
    return tuple(tree_map(lambda t: t[i], tree, is_leaf=is_tuple)
                 for i in range(n))
