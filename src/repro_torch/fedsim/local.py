"""Client-side local training (Algorithm 3), vectorized over the cohort.

Counterpart of ``local_update`` and ``cohort_updates`` in
repro/fedsim/local.py.  Each client runs ``tau`` full-batch gradient steps on
its own data from the broadcast model and returns the raw local update
``Delta~_i = w_i^{(t-1,tau)} - w^{(t-1)}``.  The gradient is
``torch.func.grad`` of the plain loss, and ``torch.func.vmap`` runs the whole
cohort as one batched program.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["local_update", "cohort_updates"]


def local_update(loss_fn: Callable, w0: torch.Tensor, client_batch, tau: int,
                 eta_l: float) -> torch.Tensor:
    """tau steps of full-batch GD on one client's data; returns the update."""
    grad_fn = torch.func.grad(loss_fn)
    w = w0
    for _ in range(tau):
        w = w - eta_l * grad_fn(w, client_batch)
    return w - w0


def cohort_updates(loss_fn: Callable, w: torch.Tensor, client_batches, tau: int,
                   eta_l: float) -> torch.Tensor:
    """(M, d) matrix of raw local updates for the full cohort.

    ``client_batches`` is a dict (or other tree) of tensors whose leading
    axis is the client axis.
    """
    return torch.func.vmap(
        lambda batch: local_update(loss_fn, w, batch, tau, eta_l))(client_batches)
