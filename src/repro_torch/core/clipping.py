"""L2 clipping of client updates (counterpart of repro/core/clipping.py).

Each client clips its local update before release:

    Delta_i <- min{ C / ||Delta~_i||, 1 } * Delta~_i

which bounds the l2-sensitivity of the round release by C (LDP) / 2C/M (CDP
mean, substitution adjacency).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["l2_norm", "clip_by_l2", "clip_batch", "global_l2_norm_tree", "clip_tree"]

_EPS = 1e-12


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of a flat vector (stable for zero vectors)."""
    return torch.sqrt(torch.sum(x * x))


def clip_by_l2(x: torch.Tensor, clip_norm) -> torch.Tensor:
    """``min(1, C/||x||) * x`` for a flat update vector."""
    scale = torch.clamp(clip_norm / torch.clamp(l2_norm(x), min=_EPS), max=1.0)
    return x * scale


def clip_batch(updates: torch.Tensor, clip_norm) -> torch.Tensor:
    """Clip a batch of client updates of shape ``(M, d)`` row-wise."""
    norms = torch.sqrt(torch.sum(updates * updates, dim=-1, keepdim=True))
    return updates * torch.clamp(clip_norm / torch.clamp(norms, min=_EPS), max=1.0)


def global_l2_norm_tree(tree) -> torch.Tensor:
    """Global L2 norm across all leaves of a parameter tree (dicts, lists, tensors)."""
    sq = sum(torch.sum(leaf.to(torch.float32) ** 2) for leaf in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_tree(tree, clip_norm):
    """Clip a parameter tree by its *global* L2 norm: one scale ``min(1, C /
    ||tree||)`` for every leaf, computed in float32, each leaf scaled in
    float32 and cast back to its dtype.  Returns ``(clipped tree, norm)``."""
    nrm = global_l2_norm_tree(tree)
    scale = torch.clamp(clip_norm / torch.clamp(nrm, min=_EPS), max=1.0)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale).to(leaf.dtype), tree), nrm
