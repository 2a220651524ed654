"""Parameter trees: nested dicts, lists and tuples of tensors (or arrays).

Leaves are visited in the JAX package's order — dict keys sorted, sequences
in order — so a tree flattens the way ``jax.flatten_util.ravel_pytree``
flattens the same tree on the JAX side.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_leaves", "tree_map", "tree_stack"]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``tree`` with every leaf replaced by ``fn(leaf, *leaves of rest)``; the
    trees in ``rest`` have ``tree``'s structure, and containers keep their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_stack(trees: list):
    """One tree whose leaves are ``torch.stack`` of the trees' leaves (same structure)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)
