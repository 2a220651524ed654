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

The other ``LocalSpec`` trainers (``local_update_spec``): minibatch SGD over
local epochs, a FedProx proximal term and client momentum, written with
tree maps so that any parameter tree trains.  A minibatch client draws a
fresh shuffle of its samples each epoch (``local_shuffles``): Threefry-2x32
(the LDP noise's counter hash) keyed by the round's seed and
``LOCAL_TRAIN_TAG`` over (global client index, epoch, sample), sorted.  No
generator is read, so the shuffles never move the round's cohort, noise or
fault draws; a gathered block shuffles its clients as the dense round does,
and a resumed run redraws the same shuffles.  ``build_cohort_local_fn`` binds
a spec to the trainer the round calls.

A straggler (``FaultSpec``) commits only its first ``steps`` of the local
steps (``steps=``).

A sampled round (``CohortSpec``) zeroes the updates of the clients left out
(``mask_rows``) or trains only the sampled ones: ``gather_slots`` packs the
host mask into a static slot table, on the host, and ``gather_rows`` takes
those clients' data on the device.

The streaming engine walks the cohort in chunks of the grid of
``kernels.dp_aggregate.ref.chunk_grid``: M is padded to a multiple of the
chunk with rows that repeat client 0 and carry mask 0, and chunk j holds
global clients ``[j c, (j + 1) c)``.  Its round takes each chunk's rows as
it trains it (``fedsim.server.chunk_plan``); ``pad_cohort`` and
``chunk_cohort`` lay the whole cohort on that grid at once.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.aggregation import global_client_indices
from repro_torch.fedsim.specs import LOCAL_TRAIN_TAG, LocalSpec
from repro_torch.kernels.dp_aggregate.ref import chunk_grid, threefry2x32
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["local_update", "cohort_updates", "local_update_scaffold", "cohort_updates_scaffold",
           "local_update_spec", "cohort_updates_spec", "local_shuffles", "shuffle_key",
           "build_cohort_local_fn", "mask_rows", "gather_slots", "gather_rows", "pad_cohort",
           "chunk_cohort"]


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


def local_update_spec(loss_fn: Callable, w0, client_batch, perms: torch.Tensor | None,
                      spec: LocalSpec, tau: int, eta_l: float,
                      steps: torch.Tensor | None = None):
    """Spec-driven local training of one client; returns the update tree.

    ``w0`` is any parameter tree (a flat (d,) vector is the one-leaf case);
    every update is a ``tree_map``.  With ``spec.batch_size`` set, step s of
    epoch e trains on samples ``perms[e, s*b:(s+1)*b]`` of the client's n
    (``perms`` an (epochs, n) int64 tensor of permutations, b =
    min(batch_size, n)), ``epochs x max(1, n // b)`` steps in all; leaves
    without the per-sample axis ride along whole.  Otherwise ``tau``
    full-batch steps, and ``perms`` is not read.  FedProx adds ``prox_mu *
    (w - w0)`` to each gradient; client momentum steps by ``v = momentum * v
    + g``, v zero at the start.  ``steps`` is the straggler cutoff: step i
    commits the (w, v) carry only while i < steps, as ``local_update``'s.
    """
    grad_fn = torch.func.grad(loss_fn)

    def step(w, v, batch):
        g = grad_fn(w, batch)
        if spec.prox_mu:
            g = tree_map(lambda gg, ww, w0l: gg + spec.prox_mu * (ww - w0l), g, w, w0)
        if spec.momentum:
            v = tree_map(lambda vv, gg: spec.momentum * vv + gg, v, g)
            g = v
        return tree_map(lambda ww, dd: ww - eta_l * dd, w, g), v

    if spec.batch_size is None:
        batches = [client_batch] * tau
    else:
        leaves = tree_leaves(client_batch)
        if not leaves or leaves[0].dim() < 1:
            raise ValueError("LocalSpec(batch_size=...) needs client batches with a leading "
                             "per-sample axis")
        n = leaves[0].shape[0]
        b = min(spec.batch_size, n)
        idxs = perms[:, :max(1, n // b) * b].reshape(-1, b)
        batches = [tree_map(lambda x, i=i: x[i] if x.dim() >= 1 and x.shape[0] == n else x,
                            client_batch) for i in idxs.unbind(0)]
    w, v = w0, tree_map(torch.zeros_like, w0) if spec.momentum else None
    for i, batch in enumerate(batches):
        w_new, v_new = step(w, v, batch)
        if steps is None:
            w, v = w_new, v_new
        else:
            w = tree_map(lambda a, c: torch.where(i < steps, a, c), w_new, w)
            if v is not None:
                v = tree_map(lambda a, c: torch.where(i < steps, a, c), v_new, v)
    return tree_map(lambda a, c: a - c, w, w0)


def shuffle_key(round_seed: int) -> torch.Tensor:
    """The two key words of a round's local-training shuffles, ``SeedSequence(
    [round_seed, LOCAL_TRAIN_TAG])``, as a (2,) int64 host tensor (the staged
    round hands them to the body on the device)."""
    words = np.random.SeedSequence([int(round_seed), LOCAL_TRAIN_TAG]).generate_state(
        2, np.uint32)
    return torch.tensor([int(k) for k in words], dtype=torch.int64)


def local_shuffles(key: torch.Tensor, clients: torch.Tensor, epochs: int, n: int) -> torch.Tensor:
    """(m, epochs, n) int64: client ``clients[j]``'s shuffle of its n samples
    in each epoch of a round, on ``clients``' device.

    Sample s of epoch e takes the 63-bit sort key ``(b0 >> 1) << 32 | b1`` of
    ``(b0, b1) = threefry2x32(key, (client, e * n + s))``, ``key`` the round's
    two key words (``shuffle_key`` of its seed, a (2,) int64 tensor on
    ``clients``' device); a stable sort of each (client, epoch) row's keys
    gives its permutation.  A client's shuffle depends on nothing but the
    round's seed and its global index, and only integer arithmetic on the
    device produces it: no host read, no generator.
    """
    k0, k1 = key[0], key[1]
    m = clients.shape[0]
    counters = torch.arange(epochs * n, dtype=torch.int64, device=clients.device)
    b0, b1 = threefry2x32(k0, k1, clients.to(torch.int64)[:, None].expand(m, epochs * n),
                          counters[None, :].expand(m, epochs * n))
    keys = ((b0 >> 1) << 32) | b1
    return torch.sort(keys.reshape(m, epochs, n), dim=-1, stable=True).indices


def cohort_updates_spec(loss_fn: Callable, w, client_batches, spec: LocalSpec, tau: int,
                        eta_l: float, key: torch.Tensor | None = None, start=0,
                        steps: torch.Tensor | None = None, perms: torch.Tensor | None = None):
    """Spec-driven updates of a block of m clients, vmapped: a tree whose
    leaves lead with the block's axis.

    A minibatch spec shuffles client j of the block by ``local_shuffles`` of
    the round's key words ``key`` (``shuffle_key`` of the round's seed) and
    its global index (``start + j``, or ``start[j]`` for a gathered block's
    slot tensor), so a gathered
    block trains its clients as the dense round does.  ``perms`` (m, epochs,
    n) replaces those shuffles (a test feeds the JAX package's through it).
    ``steps``: per-client straggler cutoffs (``local_update_spec``)."""
    if spec.batch_size is not None and perms is None:
        if key is None:
            raise ValueError("a minibatch LocalSpec draws its shuffles from the round's seed: "
                             "pass key=shuffle_key(round_seed) (or perms=)")
        leaf = tree_leaves(client_batches)[0]
        clients = global_client_indices(start, leaf.shape[0], leaf.device)
        perms = local_shuffles(key, clients, spec.epochs, leaf.shape[1])
    return torch.func.vmap(
        lambda batch, p, s: local_update_spec(loss_fn, w, batch, p, spec, tau, eta_l, steps=s),
        in_dims=(0, None if perms is None else 0, None if steps is None else 0))(
            client_batches, perms, steps)


def build_cohort_local_fn(loss_fn: Callable, spec: LocalSpec | None, tau: int) -> Callable:
    """The trainer that the round calls for ``spec`` (None or the default:
    full-batch GD):

        local_fn(w, client_batches, eta_l, *ctx, steps=None)  -> (m, d) updates

    ``cohort_updates`` for the default spec, bit for bit; SCAFFOLD's trainer
    for ``control_variates`` (``ctx`` the algorithm's ``(c_i rows, c)``);
    otherwise ``cohort_updates_spec``, whose trainer also takes ``key=``
    (the round's shuffle key) and ``start=`` (the block's global indices) and
    says so by ``uses_round_seed`` (``fedsim.server.local_caller`` reads it)."""
    if spec is not None and spec.control_variates:
        def local_fn(w, client_batches, eta_l, ctx, steps=None):
            return cohort_updates_scaffold(loss_fn, w, client_batches, tau, eta_l, ctx,
                                           steps=steps)
        return local_fn
    if spec is None or spec.is_default:
        def local_fn(w, client_batches, eta_l, steps=None):
            return cohort_updates(loss_fn, w, client_batches, tau, eta_l, steps=steps)
        return local_fn

    def local_fn(w, client_batches, eta_l, steps=None, *, key=None, start=0):
        return cohort_updates_spec(loss_fn, w, client_batches, spec, tau, eta_l, key, start,
                                   steps=steps)
    local_fn.uses_round_seed = True
    return local_fn


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


def pad_cohort(client_batches, multiple: int):
    """Every leaf padded to a multiple of ``multiple`` clients: ``(batches,
    mask)``, the rows of ``chunk_grid(M, multiple)``.

    The padding rows repeat client 0 (real data, so a loss sees nothing
    degenerate and the padded local training stays finite), and the (m_pad,)
    float32 host ``mask`` is 1 on the M real clients and 0 on the padding,
    which keeps the padding out of every sum and count."""
    leaves = tree_leaves(client_batches)
    if not leaves:
        raise ValueError("client_batches has no tensor leaves")
    m = leaves[0].shape[0]
    grid = list(chunk_grid(m, multiple))
    idx, mask = (torch.cat([g[i] for g in grid]) for i in (1, 2))
    if idx.shape[0] == m:
        return client_batches, mask
    return tree_map(lambda x: x.index_select(0, idx.to(x.device)), client_batches), mask


def chunk_cohort(client_batches, chunk_clients: int):
    """The cohort on the streaming engine's chunk grid: ``(grid, mask)``.

    M is padded to a multiple of ``chunk_clients`` (``pad_cohort``) and every
    leaf reshaped from (m_pad, ...) to (n_chunks, chunk_clients, ...); the
    host mask comes back as (n_chunks, chunk_clients).  Chunk j holds the
    global clients ``[j c, (j + 1) c)``: the rows the engine's round takes
    for its chunk j, laid out all at once."""
    if chunk_clients < 1:
        raise ValueError(f"chunk_clients must be >= 1, got {chunk_clients}")
    batches, mask = pad_cohort(client_batches, chunk_clients)
    n_chunks = mask.shape[0] // chunk_clients
    return (tree_map(lambda x: x.reshape((n_chunks, chunk_clients) + tuple(x.shape[1:])),
                     batches),
            mask.reshape(n_chunks, chunk_clients))
