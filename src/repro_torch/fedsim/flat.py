"""Flat-parameter utilities (counterpart of repro/fedsim/flat.py).

DP-FedEXP works on flattened update vectors (clipping, noise and norms are
all over R^d), so a model is kept as one flat (d,) vector plus an unravel
function.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_leaves

__all__ = ["flatten_model"]


def flatten_model(params_tree) -> tuple[torch.Tensor, Callable]:
    """``(flat_params, unravel_fn)`` for a tree of tensors.

    The leaf order is ``jax.flatten_util.ravel_pytree``'s: dict keys sorted,
    each leaf raveled in C order, all cast to their common dtype.
    ``unravel_fn(flat)`` rebuilds the tree from views of ``flat`` and works
    inside ``torch.func`` transforms.
    """
    leaves = tree_leaves(params_tree)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    specs = [(leaf.shape, leaf.dtype, leaf.numel()) for leaf in leaves]

    def rebuild(tree, flat_vec, pos):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out[k], pos = rebuild(tree[k], flat_vec, pos)
            return out, pos
        if isinstance(tree, (list, tuple)):
            items = []
            for x in tree:
                item, pos = rebuild(x, flat_vec, pos)
                items.append(item)
            return type(tree)(items), pos
        shape, leaf_dtype, n = specs[pos[1]]
        leaf = flat_vec[pos[0]:pos[0] + n].reshape(shape).to(leaf_dtype)
        return leaf, (pos[0] + n, pos[1] + 1)

    def unravel(flat_vec: torch.Tensor):
        return rebuild(params_tree, flat_vec, (0, 0))[0]

    return flat, unravel
