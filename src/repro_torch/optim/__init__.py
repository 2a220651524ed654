"""Server-side optimizers for federated pseudo-gradients (counterpart of
repro/optim).

``sgd`` recovers the paper's server update; ``adam`` and ``momentum`` are the
FedOpt family (Reddi et al., 2021).  Each is a pure ``(grad-like, state) ->
(step, state)`` transform over a flat tensor or a tree of tensors, written
as the JAX package's formulas (not through ``torch.optim``).  Every state
lives on the parameters' device, Adam's step count too, so no update reads
the device from the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_update"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any], tuple[Any, Any]]  # (grad-like, state) -> (step, state)


def _tmap2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure."""
    leaves = iter(tree_leaves(b))
    return tree_map(lambda x: fn(x, next(leaves)), a)


def sgd(lr: float = 1.0) -> Optimizer:
    """Plain scaling: lr = 1 is exactly the paper's server update."""

    def init(params):
        return ()

    def update(g, state):
        return tree_map(lambda x: lr * x, g), state

    return Optimizer(init, update)


def momentum(lr: float = 1.0, beta: float = 0.9) -> Optimizer:
    """Heavy-ball server momentum: m <- beta m + g, step lr m."""

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(g, m):
        m = _tmap2(lambda mm, gg: beta * mm + gg.to(torch.float32), m, g)
        return tree_map(lambda mm: lr * mm, m), m

    return Optimizer(init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """FedAdam (server Adam over pseudo-gradients); bias corrections
    ``1 - b**t`` in float32, t an int32 count on the parameters' device."""

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return (z, tree_map(torch.clone, z), torch.zeros((), dtype=torch.int32, device=device))

    def update(g, state):
        m, v, t = state
        t = t + 1
        m = _tmap2(lambda mm, gg: b1 * mm + (1 - b1) * gg.to(torch.float32), m, g)
        v = _tmap2(lambda vv, gg: b2 * vv + (1 - b2) * torch.square(gg.to(torch.float32)), v, g)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
        step = _tmap2(lambda mm, vv: lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps), m, v)
        return step, (m, v, t)

    return Optimizer(init, update)


def apply_update(params, step):
    """w <- w + step (pseudo-gradient ascent on the aggregated update)."""
    return _tmap2(lambda p, s: (p.to(torch.float32) + s.to(torch.float32)).to(p.dtype),
                  params, step)
