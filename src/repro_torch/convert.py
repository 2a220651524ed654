"""Parameters of the JAX package -> parameters of the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

__all__ = ["params_from_jax"]


def params_from_jax(tree, device) -> object:
    """Turn ``jax.device_get(params)`` — a tree of numpy arrays (dicts such as
    the README's ``{"W", "b"}``, lists, or one flat (d,) vector) — into the
    same tree of tensors on ``device``.

    Each leaf is copied (``device_get`` may hand out read-only views) and
    keeps its dtype and shape, so ``flatten_model`` of the result lists the
    values in ``ravel_pytree``'s order.
    """
    device = resolve_device(device)
    return tree_map(lambda leaf: torch.from_numpy(np.array(leaf, copy=True)).to(device), tree)
