"""Parameter trees as the JAX package walks them (``jax.tree_util``).

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
numpy arrays, or scalars) as leaves. The order is JAX's: a dict's keys
sorted, a sequence by index, a NamedTuple by field; a leaf's key path is
the dict key, the index or the field name. The optimizer state and the
checkpoint format (``checkpoint/checkpoint.py``) follow it, so their keys
equal the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "leaves", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``[(key, child)]`` of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree) -> list[tuple[tuple, Any]]:
    """``[(key path, leaf)]`` in JAX's order."""
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((k,) + path, leaf) for k, child in kids
            for path, leaf in flatten(child)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        built = {k: build(c) for k, c in kids}
        if isinstance(node, dict):
            return {k: built[k] for k in node}     # the caller's key order
        if _is_namedtuple(node):
            return type(node)(**built)
        return type(node)(built[i] for i in range(len(node)))

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    trees of the same structure)."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
