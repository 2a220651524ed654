"""The round loop (counterpart of repro/fedsim/server.py).

Ported so far: ``RunResult`` with ``avg_last`` iterate averaging, the
branches of ``_round_step`` that run on one device, the eager round loop of
``_run_eager`` with its divergence watchdog, as a plain Python loop that
threads the round index t into every round (noise schedules read it), and
the streamed round of ``_stream_round_step`` and ``_gather_stream_round_step``
with the staging of host-resident client data.
A full-participation round is one dense ``apply_round_stateful``.  A sampled
round (``CohortSpec``) is the masked-moment protocol: the cohort mask, drawn
first from the round's generator on the host, then the algorithm's noise
for all M clients; local training on every client, or with ``gather`` on
the sampled ones only; ``mask_rows``; ``local_moments``; the count
resolved; ``apply_from_moments``.  An algorithm that declares
``uses_local_context`` (DP-SCAFFOLD) has ``local_context(state, start, m)``
appended to the trainer call in both rounds (``local_caller``): each block
of clients trains on its own rows of the server's carry; its
``local_moments`` also gets the block's host mask (``host_mask=``), by which
it expands a with-replacement multiplicity without reading the device.  A
``LocalSpec`` trainer gets the round generator's seed and the block's global
indices, which key its minibatch shuffles.

An injecting ``FaultSpec`` takes the masked-moment protocol even under full
participation (a mask of ones): the round's fault draws (``fault_masks``,
gathered by slot with the batches), local training with the stragglers'
step counts, ``apply_faults``, ``local_moments`` (the failed rows gated out
in ``dp_aggregate``), ``sanitize_moments``, the realized count clamped,
``apply_from_moments``.  With ``watchdog`` the loop reads the device once a
round (``run_rounds``): a round with a non-finite model or a step size that
is NaN or above ``eta_max`` is not committed, and the run stops there.

The streamed round (``stream_round_step``, ``EngineSpec(engine="stream")``)
is the masked-moment round walked in chunks of clients: the same host draws
in the same order (the cohort mask when sampled, the noise for all M, the
faults), then a plan of chunks on the host (``chunk_plan``: chunk j of the
padded grid, or of a gathered round's slot table), and per chunk local
training, the faults, ``local_moments`` at the chunk's global indices, and
the moments added into a running sum (``add_moments``).  One (chunk, d)
block of updates is live at a time.  The chunk's rows come from the
device-resident cohort (a view, or a gather by slot) or, for a
``ClientDataSource``, from ``host_chunks``: fetched on the host, copied to
the card from pinned memory on a side stream, ``prefetch`` chunks ahead.

Nothing else in the loop waits for the device: host values reach it by
pinned non-blocking copies, histories stay tensors until the run ends, and
state such as an adaptive clip threshold or DP-SCAFFOLD's variate table
stays on the device.  Sharding comes in a later slice (ROADMAP.md, queue 1,
item 16).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.aggregation import add_moments
from repro_torch.core.algorithm import (
    ServerAlgorithm,
    clamp_moment_counts,
    host_to_device,
    round_generator,
    set_moment_count,
)
from repro_torch.fedsim.faults import (
    apply_faults,
    fault_masks,
    gather_fault_rows,
    resolve_steps,
    sanitize_moments,
)
from repro_torch.fedsim.data import ClientDataSource
from repro_torch.fedsim.local import gather_rows, gather_slots, mask_rows
from repro_torch.fedsim.specs import CohortSpec, FaultSpec
from repro_torch.kernels.dp_aggregate.ref import chunk_grid, grid_rows
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["RunResult", "run_rounds", "assemble_result", "round_step", "sampled_round",
           "local_caller", "block_moments", "stream_round_step", "chunk_plan", "host_chunks"]


@dataclasses.dataclass
class RunResult:
    """Outputs of a federated run: final/last weights + per-round histories."""

    final_w: Any                  # average of the last `avg_last` iterates
    last_w: Any                   # tree-shaped when the session got a tree
    eta_history: torch.Tensor     # (T,)
    metric_history: torch.Tensor  # (T,) eval metric per round (nan if no
    #                               eval_fn or the round is off cadence)
    eta_naive_history: torch.Tensor | None = None
    eta_target_history: torch.Tensor | None = None
    fault_round: int | None = None  # watchdog: the round that diverged

    def eval_rounds(self) -> list[tuple[int, float]]:
        """(round, metric) pairs for the rounds the eval cadence evaluated (the
    NaN of rounds off the cadence or after a watchdog trip dropped)."""
        return [(t, v) for t, v in enumerate(self.metric_history.tolist())
                if math.isfinite(v)]


def _eval_metric(eval_fn, eval_every: int, w_next, t: int, device) -> torch.Tensor:
    """Per-round metric honoring the eval cadence (NaN off cadence)."""
    if eval_fn is None or (t + 1) % eval_every:
        return torch.full((), float("nan"), device=device)
    return torch.as_tensor(eval_fn(w_next), dtype=torch.float32)


def local_caller(local_fn: Callable, algorithm: ServerAlgorithm,
                 fault: FaultSpec | None = None, tau: int = 1) -> Callable:
    """The trainer as ``call(w, batches, eta_l, start, state, straggler=None,
    seed=None)``.

    It is ``local_fn(w, batches, eta_l)``; when the algorithm declares
    ``uses_local_context``, ``algorithm.local_context(state, start, m)`` of
    the block's m clients at ``start`` (0, or a gathered block's host slot
    tensor) is appended as a fourth argument.  When ``fault`` cuts
    stragglers short, the block's per-client step counts
    (``resolve_steps`` of its host ``straggler`` rows, copied to the device)
    go in as ``steps=``: a straggler's ``straggler_steps`` and every other
    client's ``tau``, for every trainer, as in the JAX package (a minibatch
    client with more than tau steps stops at tau under a fault model).  A
    trainer that declares ``uses_round_seed`` (a non-default ``LocalSpec``'s)
    also gets the round's ``seed=`` and the block's ``start=``, which key a
    minibatch client's shuffles."""
    with_ctx = getattr(algorithm, "uses_local_context", False)
    straggling = fault is not None and fault.straggler > 0.0
    keyed = getattr(local_fn, "uses_round_seed", False)

    def call(w, batches, eta_l, start, state, straggler=None, seed=None):
        args, kw = (w, batches, eta_l), {}
        if with_ctx:
            m = tree_leaves(batches)[0].shape[0]
            args += (algorithm.local_context(state, start, m),)
        if straggling:
            kw["steps"] = host_to_device(resolve_steps(fault, straggler, tau), w.device)
        if keyed:
            kw.update(seed=seed, start=start)
        return local_fn(*args, **kw)

    return call


def _resolve_sampled_count(moments, cohort: CohortSpec | None, algorithm):
    """The client count of a masked round's moments: a fixed cohort's size
    (static), else the count clamped to >= 1, so an empty Bernoulli round or
    an all-failed faulted round is a zero update and not NaN.  A weighted
    count is a weight sum: only the empty round is guarded (floor 1e-12).
    A faulted round passes ``cohort`` None: its realized count, below the
    nominal one, is known only on the device."""
    if getattr(algorithm, "supports_static_count", True):
        if cohort is not None and cohort.size is not None:
            return set_moment_count(moments, cohort.size)
        return clamp_moment_counts(moments)
    return clamp_moment_counts(moments, floor=1e-12)


def block_moments(algorithm: ServerAlgorithm, local: Callable, w, state, noise, batches, mask,
                  start, t, eta_l, *, cohort: CohortSpec | None = None,
                  fault: FaultSpec | None = None, faults=None, round_seed: int | None = None):
    """Local training and the release's moments of one block of clients.

    ``local`` is the trainer as ``local_caller`` builds it; ``batches`` the
    block's data on the device; ``mask`` its (m,) host participation mask;
    ``start`` its global indices (an int, or a (m,) host tensor of slots).
    With an injecting ``fault``, ``faults`` holds the block's rows of the
    round's ``(alive, straggler, corrupt)`` draws: the stragglers train
    fewer steps, the failed rows are gated out (``apply_faults``), and the
    host's view of the mask follows.  Returns ``local_moments``' sums."""
    injecting = fault is not None and fault.injects
    alive, straggler, corrupt = faults if injecting else (None, None, None)
    host_mask, mask = mask, host_to_device(mask, w.device)
    deltas = local(w, batches, eta_l, start, state, straggler, round_seed)
    if injecting:
        deltas, mask = apply_faults(deltas, mask, *(
            None if v is None else host_to_device(v, w.device) for v in (alive, corrupt)))
        # the host's view of the realized rows (the finite screen of a client
        # that diverged by itself is known only on the device)
        if alive is not None:
            host_mask = host_mask * alive
        if corrupt is not None:
            host_mask = host_mask * (1.0 - corrupt)
    else:
        deltas = mask_rows(deltas, mask)
    extra = {"host_mask": host_mask} if getattr(algorithm, "uses_local_context", False) else {}
    binary = cohort is None or not cohort.replace
    return algorithm.local_moments(noise, w, deltas, mask, start, state, t,
                                   binary_mask=binary, **extra)


def sampled_round(algorithm: ServerAlgorithm, local_fn: Callable, w, state, noise, mask,
                  cohort: CohortSpec | None, t, client_batches, eta_l, *,
                  fault: FaultSpec | None = None, faults=None, tau: int = 1,
                  round_seed: int | None = None):
    """One masked-moment round for the host participation ``mask`` (M,) and
    the round's ``noise`` (drawn for all M clients): ``-> (w_next, aux, state)``.

    ``cohort`` None is full participation (a faulted round's mask of ones).
    With an injecting ``fault``, ``faults`` is the round's ``(alive,
    straggler, corrupt)`` host draws for all M clients (``fault_masks``)
    and ``tau`` the local step count a straggler is cut from.
    ``round_seed`` (the round generator's seed) keys a minibatch trainer's
    shuffles (``local_caller``)."""
    m = mask.shape[0]
    injecting = fault is not None and fault.injects
    if cohort is not None and cohort.gather:
        slots, slot_mask, _ = gather_slots(mask, cohort.resolved_cap(m))
        client_batches = gather_rows(client_batches, host_to_device(slots, w.device))
        mask, start = slot_mask, slots
        if injecting:
            faults = gather_fault_rows(slots, *faults)
    else:
        start = 0
    moments = block_moments(algorithm, local_caller(local_fn, algorithm, fault, tau), w, state,
                            noise, client_batches, mask, start, t, eta_l, cohort=cohort,
                            fault=fault, faults=faults, round_seed=round_seed)
    if injecting:
        moments = _resolve_sampled_count(sanitize_moments(moments), None, algorithm)
    else:
        moments = _resolve_sampled_count(moments, cohort, algorithm)
    return algorithm.apply_from_moments(noise, w, moments, state, t)


def chunk_plan(mask: torch.Tensor, cohort: CohortSpec | None, chunk_clients: int):
    """The chunks of a streamed round, on the host: ``(idx, mask_j, start_j)``
    for each chunk in order.

    ``idx`` (c,) int64 are the clients whose data the chunk trains, ``mask_j``
    their participation, ``start_j`` their global indices as the moments key
    them.  Dense: chunk j of ``chunk_grid(M, c)``, global clients ``[j c,
    (j + 1) c)`` of the padded grid: ``start_j = j c``, and a row past M
    reads client 0 with mask 0 (it keeps its padded-grid index as its key;
    gated off, it draws no noise).  Gathered (``cohort.gather``): the mask
    packed by ``gather_slots`` at ``resolved_cap(M)`` rounded up to the
    chunk, chunk j of ``chunk_grid`` over that slot table, ``start_j`` its
    slots."""
    m = mask.shape[0]
    if cohort is not None and cohort.gather:
        cap = cohort.resolved_cap(m)
        c = min(chunk_clients, cap)
        slots, slot_mask, _ = gather_slots(mask, -(-cap // c) * c)
        for _, idx, _ in chunk_grid(slots.shape[0], c):
            yield slots[idx], slot_mask[idx], slots[idx]
        return
    for j0, idx, valid in chunk_grid(m, min(chunk_clients, m)):
        yield idx, mask[idx] * valid, j0


def _device_chunks(batches, plan):
    """The chunks of ``plan`` from device-resident data: a view of the rows
    when the chunk is a run of real clients (``grid_rows``), else a gather
    (padding, slots)."""
    device = tree_leaves(batches)[0].device
    for idx, mask_j, start in plan:
        if isinstance(start, int):
            rows = tree_map(lambda x: grid_rows(x, start, idx), batches)
        else:
            rows = gather_rows(batches, host_to_device(idx, device))
        yield rows, (idx, mask_j, start)


def _host_tensor(x) -> torch.Tensor:
    """A fetched numpy leaf as a host tensor; floating data as float32."""
    a = np.asarray(x)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.to(torch.float32) if t.is_floating_point() else t


def host_chunks(source: ClientDataSource, plan, device, prefetch: int = 2):
    """The chunks of ``plan`` fetched from ``source``: ``(rows, plan entry)``
    in order, ``prefetch`` chunks staged ahead.

    Each chunk's ``source.fetch(idx)`` lands in pinned host memory, which a
    side CUDA stream copies to the card without blocking; the compute stream
    waits for the copy's event before the chunk is yielded, and the rows are
    recorded on it, so the allocator does not hand their memory to the side
    stream while the chunk's work may still read it.  The pinned buffers
    stay referenced until the consumer asks for the next chunk, that is
    until this chunk's work is queued; the next fetch is issued then.
    Nothing here waits for the device.  On the CPU the staged chunks are the
    fetched tensors, and the rows are the same at every depth."""
    device = torch.device(device)
    plan = iter(plan)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    staged = collections.deque()

    def stage():
        entry = next(plan, None)
        if entry is None:
            return
        rows = tree_map(_host_tensor, source.fetch(entry[0].numpy()))
        if not cuda:
            staged.append((rows, None, None, entry))
            return
        pinned = tree_map(lambda x: x.pin_memory(), rows)
        with torch.cuda.stream(side):
            rows = tree_map(lambda x: x.to(device, non_blocking=True), pinned)
            copied = torch.cuda.Event()
            copied.record(side)
        staged.append((rows, pinned, copied, entry))

    for _ in range(prefetch):
        stage()
    while staged:
        rows, pinned, copied, entry = staged.popleft()
        if copied is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(copied)
            for x in tree_leaves(rows):
                x.record_stream(compute)
        yield rows, entry
        del pinned
        stage()


def stream_round_step(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn,
                      eval_every: int = 1, cohort: CohortSpec | None = None,
                      fault: FaultSpec | None = None, tau: int = 1, *, chunk_clients: int,
                      num_clients: int, prefetch: int = 2):
    """One streamed server round as ``step(w, state, gen, t, data, eta_l)``
    (``round_step``'s signature); ``data`` is the device-resident cohort or
    a ``ClientDataSource``.

    The round draws from ``gen`` what the eager round draws, in its order:
    the cohort mask when sampled (a full-participation round draws none),
    then ``draw_noise`` for all M clients, then the faults from their own
    generators; so a streamed round consumes the eager round's
    ``RoundNoise``.  Then per chunk of ``chunk_plan`` (``chunk_clients`` a
    chunk, or of the gathered slot table) ``block_moments``, added into a
    running sum, and the count resolved as the JAX package's stream step
    resolves it: the realized count under faults (sanitized first), the
    sampled count of a cohort, the static M under full participation, and a
    weighted round's weight sum floored at 1e-12.  Last
    ``apply_from_moments``."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects
    local = local_caller(local_fn, algorithm, fault, tau)
    m = num_clients

    def step(w, state, gen, t, data, eta_l):
        mask = cohort.round_mask(gen, m) if sampled else torch.ones(m)
        noise = algorithm.draw_noise(gen, m, w.shape[-1], w.device, t)
        seed = gen.initial_seed()
        faults = fault_masks(fault, seed, m) if injecting else None
        plan = chunk_plan(mask, cohort if sampled else None, chunk_clients)
        chunks = (host_chunks(data, plan, w.device, prefetch)
                  if isinstance(data, ClientDataSource) else _device_chunks(data, plan))
        moments = None
        for rows, (idx, mask_j, start) in chunks:
            mom = block_moments(algorithm, local, w, state, noise, rows, mask_j, start, t, eta_l,
                                cohort=cohort if sampled else None, fault=fault,
                                faults=gather_fault_rows(idx, *faults) if injecting else None,
                                round_seed=seed)
            moments = mom if moments is None else add_moments(moments, mom)
        if injecting:
            moments = _resolve_sampled_count(sanitize_moments(moments), None, algorithm)
        elif sampled or not getattr(algorithm, "supports_static_count", True):
            moments = _resolve_sampled_count(moments, cohort if sampled else None, algorithm)
        else:
            moments = set_moment_count(moments, m)
        w_next, aux, state = algorithm.apply_from_moments(noise, w, moments, state, t)
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        return w_next, state, (aux.eta_g, metric, aux.eta_naive, aux.eta_target)

    return step


def round_step(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn, eval_every: int = 1,
               cohort: CohortSpec | None = None, fault: FaultSpec | None = None, tau: int = 1):
    """One server round as ``step(w, state, gen, t, batches, eta_l)``: the
    dense round, or with a sampling ``cohort`` or an injecting ``fault``
    the masked-moment round.  The faulted round draws its cohort mask and
    noise from ``gen`` as the sampled round does, and its faults from
    generators of their own keyed by ``gen``'s seed (``fault_masks``); a
    minibatch trainer's shuffles are keyed by that seed too."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects
    local = local_caller(local_fn, algorithm)

    def step(w, state, gen, t, client_batches, eta_l):
        if not sampled and not injecting:
            deltas = local(w, client_batches, eta_l, 0, state, seed=gen.initial_seed())
            w_next, aux, state = algorithm.apply_round_stateful(gen, w, deltas, state, t=t)
        else:
            m = tree_leaves(client_batches)[0].shape[0]
            mask = cohort.round_mask(gen, m) if sampled else torch.ones(m)
            noise = algorithm.draw_noise(gen, m, w.shape[-1], w.device, t)
            faults = fault_masks(fault, gen.initial_seed(), m) if injecting else None
            w_next, aux, state = sampled_round(algorithm, local_fn, w, state, noise, mask,
                                               cohort if sampled else None, t, client_batches,
                                               eta_l, fault=fault, faults=faults, tau=tau,
                                               round_seed=gen.initial_seed())
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        return w_next, state, (aux.eta_g, metric, aux.eta_naive, aux.eta_target)

    return step


def _healthy(w_next, eta, eta_max: float) -> bool:
    """The watchdog's one read of the device a round: a finite model and a
    step size that is neither NaN nor above ``eta_max``."""
    ok = torch.isfinite(w_next).all() & (eta.to(w_next.device) <= eta_max)
    return bool(ok)


def run_rounds(step, carry, seed: int, start: int, end: int, client_batches, eta_l, *,
               avg_last: int, fault: FaultSpec | None = None):
    """Rounds ``[start, end)`` of ``step`` from ``carry = (w, state, tail)``
    (``tail`` the list of up to ``avg_last`` trailing iterates); round t
    draws from ``round_generator(seed, t)``.

    Returns ``(carry, outs, fault_round)``: ``outs`` one history tuple a
    round run.  With ``fault.watchdog`` a round that trips the watchdog is
    run (its history is kept) but not committed, the loop stops, and
    ``fault_round`` is that round; else it is None."""
    w, state, tail = carry
    tail = list(tail)
    watchdog = fault is not None and fault.watchdog
    outs = []
    for t in range(start, end):
        w_next, state_next, out = step(w, state, round_generator(seed, t), t, client_batches,
                                       eta_l)
        outs.append(out)
        if watchdog and not _healthy(w_next, out[0], fault.eta_max):
            return (w, state, tail), outs, t
        w, state = w_next, state_next
        tail.append(w)
        if len(tail) > avg_last:
            tail.pop(0)
    return (w, state, tail), outs, None


def stack_outs(outs, device) -> tuple:
    """The four (n,) history tensors of n rounds' history tuples."""
    if not outs:
        return tuple(torch.zeros(0, device=device) for _ in range(4))
    return tuple(torch.stack([o[i].to(device) for o in outs]) for i in range(4))


def assemble_result(carry, hist, rounds: int, fault_round: int | None = None) -> RunResult:
    """The ``RunResult`` of a run whose histories ``hist`` (four tensors)
    cover the rounds run: after a watchdog trip the rounds skipped record
    NaN, and a run tripped before any round committed averages ``w0``."""
    w, _, tail = carry
    hist = tuple(torch.cat([h, torch.full((rounds - h.shape[0],), float("nan"),
                                          device=h.device)]) for h in hist)
    tail = tail or [w]
    return RunResult(final_w=torch.stack(tail).mean(dim=0), last_w=w, eta_history=hist[0],
                     metric_history=hist[1], eta_naive_history=hist[2],
                     eta_target_history=hist[3], fault_round=fault_round)
