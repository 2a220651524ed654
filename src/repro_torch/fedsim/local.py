"""Client-side local training (Algorithm 3), vectorized over the cohort.

Counterpart of ``local_update`` and ``cohort_updates`` in
repro/fedsim/local.py.  Each client runs ``tau`` full-batch gradient steps on
its own data from the broadcast model and returns the raw local update
``Delta~_i = w_i^{(t-1,tau)} - w^{(t-1)}``.  The gradient is
``torch.func.grad`` of the plain loss, and ``torch.func.vmap`` runs the whole
cohort as one batched program.

SCAFFOLD's trainer (``LocalSpec(control_variates=True)``) steps by the
drift-corrected direction ``g - c_i + c`` instead (``local_update_scaffold``),
each client with its own variate row ``c_i``, all with the global ``c``.

A straggler (``FaultSpec``) commits only its first ``steps`` of the tau
steps (``steps=``).

A sampled round (``CohortSpec``) zeroes the updates of the clients left out
(``mask_rows``) or trains only the sampled ones: ``gather_slots`` packs the
host mask into a static slot table, on the host, and ``gather_rows`` takes
those clients' data on the device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_map

__all__ = ["local_update", "cohort_updates", "local_update_scaffold", "cohort_updates_scaffold",
           "mask_rows", "gather_slots", "gather_rows"]


def local_update(loss_fn: Callable, w0: torch.Tensor, client_batch, tau: int,
                 eta_l: float, steps: torch.Tensor | None = None) -> torch.Tensor:
    """tau steps of full-batch GD on one client's data; returns the update.

    ``steps`` (an int tensor, 0-d under vmap) is the straggler cutoff: all
    tau steps run and step i is committed only while i < steps, with a
    ``where``, so a vmapped cohort takes a per-client count.  None is the
    uncut loop, bit for bit."""
    grad_fn = torch.func.grad(loss_fn)
    w = w0
    for i in range(tau):
        w_new = w - eta_l * grad_fn(w, client_batch)
        w = w_new if steps is None else torch.where(i < steps, w_new, w)
    return w - w0


def cohort_updates(loss_fn: Callable, w: torch.Tensor, client_batches, tau: int,
                   eta_l: float, steps: torch.Tensor | None = None) -> torch.Tensor:
    """(M, d) matrix of raw local updates for the full cohort.

    ``client_batches`` is a dict (or other tree) of tensors whose leading
    axis is the client axis; ``steps`` an optional (M,) int tensor of
    per-client straggler cutoffs (``local_update``).
    """
    if steps is None:
        return torch.func.vmap(
            lambda batch: local_update(loss_fn, w, batch, tau, eta_l))(client_batches)
    return torch.func.vmap(
        lambda batch, s: local_update(loss_fn, w, batch, tau, eta_l, steps=s))(
            client_batches, steps)


def local_update_scaffold(loss_fn: Callable, w0: torch.Tensor, client_batch,
                          c_i: torch.Tensor, c: torch.Tensor, tau: int,
                          eta_l: float, steps: torch.Tensor | None = None) -> torch.Tensor:
    """tau SCAFFOLD control-variate steps on one client; returns the update.

    Each step is ``y - eta_l * (g - c_i + c)``, in that op order (the JAX
    package's, whose dense round is pinned to its legacy loop's bits).
    ``steps`` is the straggler cutoff, as ``local_update``'s."""
    grad_fn = torch.func.grad(loss_fn)
    y = w0
    for i in range(tau):
        y_new = y - eta_l * (grad_fn(y, client_batch) - c_i + c)
        y = y_new if steps is None else torch.where(i < steps, y_new, y)
    return y - w0


def cohort_updates_scaffold(loss_fn: Callable, w: torch.Tensor, client_batches, tau: int,
                            eta_l: float, ctx, steps: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """(m, d) control-variate updates of a block of clients.

    ``ctx`` is the algorithm's local context ``(c_i rows, c)`` for the block
    (``DPScaffoldServer.local_context``): the rows are vmapped beside the
    batches, ``c`` is shared.  ``steps``: per-client straggler cutoffs."""
    c_is, c = ctx
    if steps is None:
        return torch.func.vmap(
            lambda batch, c_i: local_update_scaffold(loss_fn, w, batch, c_i, c, tau, eta_l))(
                client_batches, c_is)
    return torch.func.vmap(
        lambda batch, c_i, s: local_update_scaffold(loss_fn, w, batch, c_i, c, tau, eta_l,
                                                    steps=s))(client_batches, c_is, steps)


def mask_rows(deltas: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the rows whose mask is not > 0, with ``where`` (not a multiply):
    a non-finite update from a left-out client's dummy rows cannot leak into
    the moments as 0 * nan."""
    return torch.where((mask > 0)[:, None], deltas, 0.0)


def gather_slots(mask: torch.Tensor, cap: int):
    """Pack a host participation mask into a dense slot table of ``cap`` rows.

    Returns, on the host:

        slots:      (cap,) int64 — slot j holds the global index of the j-th
                    participant in index order; padding slots hold 0
        slot_mask:  (cap,) float32 — the participant's mask value, 0 on padding
        overflow:   float — participants that did not fit in ``cap`` slots

    Padding slots point at client 0 (real data, so their local training stays
    finite) and carry mask 0, which keeps them out of every sum.  Computed on
    the host from the host mask, so nothing reads the device.
    """
    on = torch.nonzero(mask > 0).flatten()
    slots = torch.zeros(cap, dtype=torch.int64)
    kept = on[:cap]
    slots[:kept.numel()] = kept
    slot_mask = torch.zeros(cap, dtype=torch.float32)
    slot_mask[:kept.numel()] = mask[kept].to(torch.float32)
    return slots, slot_mask, float(max(on.numel() - cap, 0))


def gather_rows(tree, slots: torch.Tensor):
    """The slot rows of every leaf of a per-client tree (client axis leading);
    ``slots`` lies on the leaves' device."""
    return tree_map(lambda x: x.index_select(0, slots), tree)
