"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.
Parameters, gradients, optimizer and scale states are plain nested
dicts with the same keys; anything that is not a dict is a leaf (an
``OptState`` or a ``(value, value)`` pair included)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, flat: list):
    """Inverse of ``tree_leaves``: ``flat`` in ``tree``'s shape."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def tree_unzip(tree, i: int):
    """Element ``i`` of every (tuple) leaf."""
    return tree_map(lambda leaf: leaf[i], tree)
