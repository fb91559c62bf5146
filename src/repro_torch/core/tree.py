"""Nested dict / list trees of tensors, the port's layout of parameters,
gradients and optimizer state: the leaves in one fixed order (dict keys
sorted, as jax.tree orders them), and a map over trees of one structure."""
from __future__ import annotations

from typing import Callable


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *same-place subtrees of rest)`` over ``tree``'s leaves: the
    structure is ``tree``'s, so ``rest`` may hold a subtree where ``tree``
    holds a leaf (the reference's ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """``leaves``, in ``tree_leaves(like)``'s order, put in ``like``'s
    structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
