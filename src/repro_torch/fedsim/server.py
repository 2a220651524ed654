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
``local_moments`` also gets a with-replacement block's expanded rows
(``draws=``, made by the stage from the host mask).  A ``LocalSpec``
trainer gets the round's shuffle key and the block's global indices, which
key its minibatch shuffles.

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

A compressed composition (``core.compose.with_compression``) takes every
round kind as it is: its plan is a field of the round's ``RoundNoise``,
drawn once a round from a generator of its own, so the dense round, the
sampled and gathered blocks and every streamed chunk compress with the one
plan; the moments' ``sum_c`` is then (kc,) wide, and a streamed round's
running sum, which starts from its first chunk's moments, takes that width.
Its sums are plain PyTorch (no ``dp_aggregate`` launch), and its plan's
tensors have static shapes (a count-sketch's bucket order and sizes), so the
scan engine stages and replays a compressed round like any other.

Nothing else in the loop waits for the device: host values reach it by
pinned non-blocking copies, histories stay tensors until the run ends, and
state such as an adaptive clip threshold or DP-SCAFFOLD's variate table
stays on the device.

A client-sharded round (``ShardSpec``: the scan and stream engines) runs
the same round on each rank of a ``torch.distributed`` group over its slice
of the cohort (``ShardLayout``: the padded cohort's rows ``[r m_local, (r +
1) m_local)``).  Every rank draws the round's host values for the whole
cohort from the same round generator (the cohort mask, the noise for all M
clients, the faults) and keeps its rows; its block trains, releases at its
global client indices (the LDP noise keyed by global row in the kernel, a
gathered block by its slots' global indices) and reduces to moments; one
``all_reduce_moments`` a round sums them over the ranks, and every rank
applies the same server update.  A rank that holds no padding row reduces
its block as the dense round reduces the cohort, so one rank is the
unsharded round in bits.

The eager round is a host stage and a device body (``round_stage``,
``round_body``).  The stage draws from the round's generator, in the order
above, everything the round consumes (the cohort mask, the noise put in its
staged form, the faults, the gathered slot table, a with-replacement
cohort's expanded rows for DP-SCAFFOLD, a minibatch trainer's shuffle key,
the telemetry counts) and puts it on the device as a ``RoundInputs``.  The
body reads only device memory, so the scan engine (``fedsim/scan.py``)
replays it from a CUDA graph; the eager engine runs the same stage and body
uncaptured.  ``tap_payload`` is the round's telemetry: twelve float32 slots
in the JAX package's order (``telemetry/tap.py``), built on the device after
the round from what the round already holds, so a tracked round computes
what an untracked one computes.
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
    RoundNoise,
    ServerAlgorithm,
    all_reduce_moments,
    clamp_moment_counts,
    host_to_device,
    round_generator,
    set_moment_count,
    stage_tensor,
)
from repro_torch.core.variance_reduction import multiplicity_rows
from repro_torch.fedsim.faults import (
    apply_faults,
    fault_masks,
    gather_fault_rows,
    resolve_steps,
    sanitize_moments,
)
from repro_torch.fedsim.data import ClientDataSource
from repro_torch.fedsim.local import gather_rows, gather_slots, mask_rows, shuffle_key
from repro_torch.fedsim.specs import CohortSpec, FaultSpec
from repro_torch.kernels.dp_aggregate.ref import chunk_grid, grid_rows
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["RunResult", "RoundInputs", "ShardLayout", "shard_layout", "local_cohort",
           "run_rounds", "assemble_result", "round_step", "round_stage", "round_body",
           "stage_inputs", "masked_round", "local_caller", "block_moments",
           "stream_round_step", "chunk_plan", "host_chunks", "tap_counts", "tap_sigma",
           "tap_payload"]


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


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """A rank's slice of a client-sharded cohort: the rows ``[start, start +
    m_local)`` of the cohort padded to ``n_shards * m_local`` clients, whose
    rows past ``num_clients`` repeat client 0 at mask 0 (``local_cohort``).
    ``group`` is the client axis's process group, which the round's one
    all-reduce spans."""

    rank: int
    n_shards: int
    m_local: int
    num_clients: int
    group: Any = None

    @property
    def start(self) -> int:
        """The global index of the rank's first row."""
        return self.rank * self.m_local

    @property
    def padded(self) -> bool:
        """Whether the rank's slice holds a padding row."""
        return self.start + self.m_local > self.num_clients

    def pad_mask(self) -> torch.Tensor:
        """(m_local,) float32 on the host: 1 on the real clients, 0 on padding."""
        return (torch.arange(self.start, self.start + self.m_local)
                < self.num_clients).to(torch.float32)

    def rows(self, v: torch.Tensor | None) -> torch.Tensor | None:
        """The rank's rows of an (M,) host vector of the whole cohort (a mask,
        a fault class), zero on padding; None passes through."""
        if v is None:
            return None
        pad = v.new_zeros(max(0, self.start + self.m_local - v.shape[0]))
        return torch.cat([v, pad])[self.start:self.start + self.m_local]

    def reduce(self, moments, device):
        """The round's one collective: ``moments`` summed over the ranks."""
        return all_reduce_moments(moments, self.group, device)


def shard_layout(num_clients: int, n_shards: int, rank: int, group=None,
                 multiple: int = 1) -> ShardLayout:
    """The layout of rank ``rank`` of ``n_shards`` over M clients padded to a
    multiple of ``n_shards * multiple`` (``multiple`` the stream engine's
    chunk, so each rank's slice is whole chunks, as the JAX package's
    ``chunk_cohort(..., n_shards=)`` lays it out; 1 otherwise, its
    ``pad_cohort``)."""
    block = n_shards * multiple
    m_pad = -(-num_clients // block) * block
    return ShardLayout(rank=rank, n_shards=n_shards, m_local=m_pad // n_shards,
                       num_clients=num_clients, group=group)


def local_cohort(client_batches, layout: ShardLayout, device):
    """The rank's rows of the cohort ``client_batches`` on ``device``, split
    along every leaf's leading (client) axis: a slice when they are all real
    clients, else a gather whose padding rows repeat client 0 (real data:
    their training stays finite)."""
    m = layout.num_clients
    lo, hi = layout.start, layout.start + layout.m_local
    g = torch.arange(lo, hi)
    idx = torch.where(g < m, g, 0)

    def rows(x):
        if hi <= m:
            return x.narrow(0, lo, hi - lo).to(device)
        return x.index_select(0, idx.to(x.device)).to(device)

    return tree_map(rows, client_batches)


def _eval_metric(eval_fn, eval_every: int, w_next, t: int, device) -> torch.Tensor:
    """Per-round metric honoring the eval cadence (NaN off cadence)."""
    if eval_fn is None or (t + 1) % eval_every:
        return torch.full((), float("nan"), device=device)
    return torch.as_tensor(eval_fn(w_next), dtype=torch.float32)


def local_caller(local_fn: Callable, algorithm: ServerAlgorithm,
                 fault: FaultSpec | None = None, tau: int = 1) -> Callable:
    """The trainer as ``call(w, batches, eta_l, start, state, straggler=None,
    key=None)``.

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
    also gets the round's shuffle ``key=`` and the block's ``start=``, which
    key a minibatch client's shuffles."""
    with_ctx = getattr(algorithm, "uses_local_context", False)
    straggling = fault is not None and fault.straggler > 0.0
    keyed = getattr(local_fn, "uses_round_seed", False)

    def call(w, batches, eta_l, start, state, straggler=None, key=None):
        args, kw = (w, batches, eta_l), {}
        if with_ctx:
            m = tree_leaves(batches)[0].shape[0]
            args += (algorithm.local_context(state, start, m),)
        if straggling:
            kw["steps"] = host_to_device(resolve_steps(fault, straggler, tau), w.device)
        if keyed:
            kw.update(key=key, start=start)
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
                  fault: FaultSpec | None = None, faults=None, key=None, draws=None):
    """Local training and the release's moments of one block of clients.

    ``local`` is the trainer as ``local_caller`` builds it; ``batches`` the
    block's data on the device; ``noise`` the round's staged ``RoundNoise``;
    ``mask`` its (m,) participation (None: every row); ``start`` its global
    indices (an int, or a (m,) tensor of slots).  With an injecting ``fault``, ``faults`` holds
    the block's rows of the round's ``(alive, straggler, corrupt)`` draws: the
    stragglers train fewer steps, the failed rows are gated out
    (``apply_faults``).  ``key``: a minibatch trainer's shuffle key.
    ``draws``: a with-replacement block's expanded rows on the device, which
    DP-SCAFFOLD's release takes.  Returns ``local_moments``' sums."""
    injecting = fault is not None and fault.injects
    alive, straggler, corrupt = faults if injecting else (None, None, None)
    mask = None if mask is None else host_to_device(mask, w.device)
    deltas = local(w, batches, eta_l, start, state, straggler, key)
    if injecting:
        deltas, mask = apply_faults(deltas, mask, *(
            None if v is None else host_to_device(v, w.device) for v in (alive, corrupt)))
    elif mask is not None:
        deltas = mask_rows(deltas, mask)
    extra = {} if draws is None else {"draws": draws}
    binary = cohort is None or not cohort.replace
    return algorithm.local_moments(noise, w, deltas, mask, start, state, t,
                                   binary_mask=binary, **extra)


def masked_round(algorithm: ServerAlgorithm, local_fn: Callable, w, state, inp: RoundInputs,
                 cohort: CohortSpec | None, t, client_batches, eta_l, *,
                 fault: FaultSpec | None = None, tau: int = 1,
                 shard: ShardLayout | None = None):
    """One masked-moment round on its staged inputs ``inp`` (``stage_inputs``):
    ``-> (w_next, aux, state)``.

    ``cohort`` None is full participation (a faulted round's mask of ones).
    A gathered round trains the rows of ``inp.slots`` only; an injecting
    ``fault`` cuts ``inp.faults``' stragglers short of ``tau`` steps and
    gates the failed rows out.  With ``shard`` the block is the rank's slice
    (its rows keyed from ``shard.start``, a gathered block by ``inp.keys``,
    its padding rows masked by ``inp.mask``) and its moments cross the ranks
    in one all-reduce before the count is resolved.  Nothing here reads the
    host."""
    if inp.slots is not None:
        client_batches = gather_rows(client_batches, inp.slots)
        mask, start = inp.slot_mask, inp.slots if inp.keys is None else inp.keys
    else:
        mask, start = inp.mask, 0 if shard is None else shard.start
    moments = block_moments(algorithm, local_caller(local_fn, algorithm, fault, tau), w, state,
                            inp.noise, client_batches, mask, start, t, eta_l, cohort=cohort,
                            fault=fault, faults=inp.faults, key=inp.shuffle_key, draws=inp.draws)
    if shard is not None:
        moments = shard.reduce(moments, w.device)
    if fault is not None and fault.injects:
        moments = _resolve_sampled_count(sanitize_moments(moments), None, algorithm)
    elif shard is not None and cohort is None and algorithm.supports_static_count:
        # full participation: the static true M, as the dense round divides
        # by M (the JAX package's m_total)
        moments = set_moment_count(moments, shard.num_clients)
    else:
        moments = _resolve_sampled_count(moments, cohort, algorithm)
    return algorithm.apply_from_moments(inp.noise, w, moments, state, t)


def chunk_plan(mask: torch.Tensor, cohort: CohortSpec | None, chunk_clients: int,
               offset: int = 0):
    """The chunks of a streamed round, on the host: ``(idx, mask_j, start_j)``
    for each chunk in order.

    ``idx`` (c,) int64 are the rows of the data whose clients the chunk
    trains, ``mask_j`` their participation, ``start_j`` their global indices
    as the moments key them: the rows' own plus ``offset`` (a sharded rank's
    first client, whose slice of the cohort ``mask`` is).  Dense: chunk j of
    ``chunk_grid(M, c)``, clients ``[j c, (j + 1) c)`` of the padded grid:
    ``start_j = offset + j c``, and a row past M reads client 0 with mask 0
    (it keeps its padded-grid index as its key; gated off, it draws no
    noise).  Gathered (``cohort.gather``): the mask packed by
    ``gather_slots`` at ``resolved_cap(M)`` rounded up to the chunk, chunk j
    of ``chunk_grid`` over that slot table, ``start_j`` its slots plus
    ``offset``."""
    m = mask.shape[0]
    if cohort is not None and cohort.gather:
        cap = cohort.resolved_cap(m)
        c = min(chunk_clients, cap)
        slots, slot_mask, _ = gather_slots(mask, -(-cap // c) * c)
        for _, idx, _ in chunk_grid(slots.shape[0], c):
            yield slots[idx], slot_mask[idx], slots[idx] + offset
        return
    for j0, idx, valid in chunk_grid(m, min(chunk_clients, m)):
        yield idx, mask[idx] * valid, offset + j0


def _device_chunks(batches, plan):
    """The chunks of ``plan`` from device-resident data: a view of the rows
    when the chunk is a run of real clients (``grid_rows``), else a gather
    (padding, slots)."""
    device = tree_leaves(batches)[0].device
    for idx, mask_j, start in plan:
        if isinstance(start, int):
            j0 = int(idx[0])    # the chunk's first row: the grid's rows start at one
            rows = tree_map(lambda x: grid_rows(x, j0, idx), batches)
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
                      num_clients: int, prefetch: int = 2, shard: ShardLayout | None = None):
    """One streamed server round as ``step(w, state, gen, t, data, eta_l,
    tap=None)`` (``round_step``'s signature); ``data`` is the device-resident
    cohort or a ``ClientDataSource``.

    The round draws from ``gen`` what the eager round draws, in its order:
    the cohort mask when sampled (a full-participation round draws none),
    then ``draw_noise`` for all M clients, then the faults from their own
    generators; so a streamed round consumes the eager round's
    ``RoundNoise``, staged as the eager round stages it (``stage_noise``, the
    shuffle key, a with-replacement chunk's expanded rows).  Then per chunk
    of ``chunk_plan`` (``chunk_clients`` a chunk, or of the gathered slot
    table) ``block_moments``, added into a running sum, and the count resolved as the JAX package's stream step
    resolves it: the realized count under faults (sanitized first), the
    sampled count of a cohort, the static M under full participation, and a
    weighted round's weight sum floored at 1e-12.  Last
    ``apply_from_moments``.

    With ``shard`` (a rank's ``ShardLayout``) ``data`` is the rank's slice
    of the cohort (``local_cohort``): the round's mask and faults are drawn
    for all M clients and sliced, the plan walks the slice (a gathered one
    packs the slice's own slot table, as the JAX package's sharded
    gather-stream does), the chunks are keyed by global index, and the
    accumulated moments cross the ranks in one all-reduce before the count
    is resolved."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects
    local = local_caller(local_fn, algorithm, fault, tau)
    keyed = getattr(local_fn, "uses_round_seed", False)
    expand = _expands(algorithm, cohort)
    m = num_clients

    def step(w, state, gen, t, data, eta_l, tap=None):
        mask = cohort.round_mask(gen, m) if sampled else torch.ones(m)
        noise = algorithm.stage_noise(algorithm.draw_noise(gen, m, w.shape[-1], w.device, t),
                                      w.device, t)
        seed = gen.initial_seed()
        key = stage_tensor(shuffle_key(seed), w.device) if keyed else None
        faults = fault_masks(fault, seed, m) if injecting else None
        own_mask, own_faults, offset = mask, faults, 0
        if shard is not None:
            own_mask = shard.rows(mask) * shard.pad_mask()
            own_faults = None if faults is None else tuple(shard.rows(v) for v in faults)
            offset = shard.start
        plan = chunk_plan(own_mask, cohort if sampled else None, chunk_clients, offset)
        chunks = (host_chunks(data, plan, w.device, prefetch)
                  if isinstance(data, ClientDataSource) else _device_chunks(data, plan))
        moments = None
        for rows, (idx, mask_j, start) in chunks:
            mom = block_moments(algorithm, local, w, state, noise, rows, mask_j, start, t, eta_l,
                                cohort=cohort if sampled else None, fault=fault,
                                faults=gather_fault_rows(idx, *own_faults) if injecting else None,
                                key=key, draws=stage_tensor(multiplicity_rows(mask_j), w.device)
                                if expand else None)
            moments = mom if moments is None else add_moments(moments, mom)
        if shard is not None:
            moments = shard.reduce(moments, w.device)
        if injecting:
            moments = _resolve_sampled_count(sanitize_moments(moments), None, algorithm)
        elif sampled or not getattr(algorithm, "supports_static_count", True):
            moments = _resolve_sampled_count(moments, cohort if sampled else None, algorithm)
        else:
            moments = set_moment_count(moments, m)
        w_next, aux, state_next = algorithm.apply_from_moments(noise, w, moments, state, t)
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        out = (aux.eta_g, metric, aux.eta_naive, aux.eta_target)
        if tap is not None:
            counts = tap_counts(mask, faults, m, sampled) + (tap_sigma(algorithm, t),)
            tap(t, tap_payload(algorithm, state, out, host_to_device(
                torch.tensor(counts, dtype=torch.float32), w.device), -1))
        return w_next, state_next, out

    return step


@dataclasses.dataclass
class RoundInputs:
    """One round's staged inputs (``round_stage``): what the round's body
    reads, every tensor on the device.

    ``noise`` the staged ``RoundNoise``; ``mask`` the (M,) participation of
    a sampled or faulted round (None for a dense one); ``slots`` /
    ``slot_mask`` a gathered round's (cap,) slot table; ``faults`` the
    ``(alive, straggler, corrupt)`` rows of the block (None where a class is
    off); ``draws`` DP-SCAFFOLD's expanded rows of a with-replacement cohort;
    ``shuffle_key`` a minibatch trainer's key words; ``keys`` a sharded
    gathered block's global client indices (its slots plus the rank's
    first client; ``slots`` index the rank's rows).  What only the round's
    telemetry payload reads is staged when asked for (``payload``): ``t``
    the round index (0-d int64, the watchdog's round) and ``counts`` the
    (participants, realized, dropped, stragglers, corrupt, sigma) as (6,)
    float32."""

    noise: RoundNoise
    t: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    slots: torch.Tensor | None = None
    slot_mask: torch.Tensor | None = None
    faults: tuple | None = None
    draws: torch.Tensor | None = None
    shuffle_key: torch.Tensor | None = None
    keys: torch.Tensor | None = None


def tap_counts(mask, faults, num_clients: int, sampled: bool) -> tuple[float, ...]:
    """The telemetry's cohort counts of a round from its host draws, as the
    JAX package's tap computes them: participants (the mask's sum, or M),
    then realized, dropped, stragglers and corrupt clients among them (the
    fault classes that are off count as alive, on time and clean)."""
    participants = float(mask.sum()) if sampled else float(num_clients)
    if faults is None:
        return participants, participants, 0.0, 0.0, 0.0
    ones, zeros = torch.ones(num_clients), torch.zeros(num_clients)
    alive = ones if faults[0] is None else faults[0]
    strag = zeros if faults[1] is None else faults[1]
    corr = zeros if faults[2] is None else faults[2]
    m = mask if sampled else ones
    m, alive, strag, corr = (v.to(torch.float64) for v in (m, alive, strag, corr))
    return (participants, float((m * alive * (1.0 - corr)).sum()),
            float((m * (1.0 - alive)).sum()), float((m * alive * strag).sum()),
            float((m * alive * corr).sum()))


def tap_sigma(algorithm: ServerAlgorithm, t: int) -> float:
    """The telemetry's noise std of round ``t`` (the JAX package's
    ``_tap_sigma_fn``): a round-indexed schedule's sigma(t), a fixed sigma,
    else NaN (no noise std shared by the cohort)."""
    mech = getattr(algorithm, "mechanism", None)
    if mech is not None and getattr(mech, "is_round_indexed", False):
        return float(mech.sigma_at(t))
    sigma = getattr(algorithm, "sigma", None)
    return float(np.float32(sigma)) if isinstance(sigma, (int, float)) else float("nan")


def _tap_clip(algorithm: ServerAlgorithm, state, device) -> torch.Tensor:
    """The round's clip threshold for the telemetry (the JAX package's
    ``_tap_clip_fn``): the step's override from the carry, else the static
    ``clip_norm`` of the algorithm or its mechanism, else NaN."""
    state = getattr(state, "inner", state)
    step = getattr(algorithm, "step", None)
    c = step.clip_override(state) if step is not None else None
    if c is None:
        for holder in (algorithm, getattr(algorithm, "mechanism", None)):
            c = getattr(holder, "clip_norm", None)
            if c is not None:
                break
    if isinstance(c, torch.Tensor):
        return c.to(torch.float32).reshape(())
    return torch.full((), float("nan") if c is None else float(c), dtype=torch.float32,
                      device=device)


def tap_payload(algorithm: ServerAlgorithm, state, out, counts: torch.Tensor,
                fault_t) -> torch.Tensor:
    """The round's (12,) float32 telemetry payload on the device, in the
    JAX package's slot order: eta, eta_naive, eta_target, metric, clip,
    participants, realized, dropped, stragglers, corrupt, fault_t, sigma.
    ``state`` is the carry the round started from (its clip threshold),
    ``out`` the round's history tuple (eta, metric, naive, target),
    ``counts`` the staged (6,) counts, ``fault_t`` the watchdog's round (-1
    while healthy).  It only reads: nothing of the round changes."""
    eta, metric, naive, target = out
    dev = counts.device
    head = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(dev).reshape(())
                        for v in (eta, naive, target, metric)]
                       + [_tap_clip(algorithm, state, dev)])
    fault_t = (fault_t.to(torch.float32).reshape(1) if isinstance(fault_t, torch.Tensor)
               else torch.full((1,), float(fault_t), device=dev))
    return torch.cat([head, counts[:5], fault_t, counts[5:]])


def _expands(algorithm: ServerAlgorithm, cohort: CohortSpec | None) -> bool:
    """Whether a round's release takes a with-replacement cohort's expanded
    rows (``draws``): a control-variate algorithm's (DP-SCAFFOLD's)."""
    return (cohort is not None and cohort.is_sampled and cohort.replace
            and getattr(algorithm, "uses_local_context", False))


def stage_inputs(algorithm: ServerAlgorithm, local_fn: Callable, noise: RoundNoise, t: int,
                 m: int, device, *, cohort: CohortSpec | None = None,
                 fault: FaultSpec | None = None, mask=None, faults=None,
                 seed: int | None = None, payload: bool = False,
                 shard: ShardLayout | None = None) -> RoundInputs:
    """Round ``t``'s host draws as its body reads them: a ``RoundInputs`` on
    ``device``.

    ``noise`` is the round's staged noise (``stage_noise`` of its
    ``draw_noise``), ``mask`` its (M,) host cohort mask (None unless
    sampled), ``faults`` its ``fault_masks`` (None unless injecting),
    ``seed`` the round generator's seed.  A gathered round's slot table is
    packed (``gather_slots``, its fault rows gathered with it); a
    with-replacement cohort's rows expanded for a control-variate algorithm
    (from the mask before faults: the faulted rows are gated on the
    device); a minibatch trainer's shuffle key derived from ``seed``.  With
    ``payload`` the round index and the telemetry's counts are staged too.

    With ``shard`` (a rank's ``ShardLayout``) the whole cohort's ``mask``
    and ``faults`` are cut to the rank's rows (zero on padding), a gathered
    round packs the rank's own slot table at ``resolved_cap(m_local)`` and
    stages its global ``keys``; a full-participation round stages the
    padding mask, or None when the rank holds no padding row.  The payload's
    counts are the whole cohort's."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects
    inp = RoundInputs(noise=noise)
    if payload:
        counts = tap_counts(mask, faults, m, sampled) + (tap_sigma(algorithm, t),)
        inp.t = stage_tensor(int(t), device)
        inp.counts = stage_tensor(torch.tensor(counts, dtype=torch.float32), device)
    if getattr(local_fn, "uses_round_seed", False):
        inp.shuffle_key = stage_tensor(shuffle_key(seed), device)
    if shard is not None:
        pad = shard.pad_mask()
        if not sampled and not injecting:
            inp.mask = stage_tensor(pad, device) if shard.padded else None
            return inp
        mask = pad if mask is None else shard.rows(mask) * pad
        faults = None if faults is None else tuple(shard.rows(v) for v in faults)
        m = shard.m_local
    if not sampled and not injecting:
        return inp
    if mask is None:
        mask = torch.ones(m)
    if _expands(algorithm, cohort):
        inp.draws = stage_tensor(multiplicity_rows(mask), device)
    if sampled and cohort.gather:
        slots, slot_mask, _ = gather_slots(mask, cohort.resolved_cap(m))
        if injecting:
            faults = gather_fault_rows(slots, *faults)
        inp.slots, inp.slot_mask = stage_tensor(slots, device), stage_tensor(slot_mask, device)
        if shard is not None:
            inp.keys = stage_tensor(slots + shard.start, device)
    inp.mask = stage_tensor(mask, device)
    if injecting:
        inp.faults = tuple(None if v is None else stage_tensor(v, device) for v in faults)
    return inp


def round_stage(algorithm: ServerAlgorithm, local_fn: Callable, cohort: CohortSpec | None = None,
                fault: FaultSpec | None = None, shard: ShardLayout | None = None):
    """The host half of a round as ``stage(gen, t, m, d, device, payload=False)
    -> RoundInputs``.

    It draws from ``gen`` what ``round_step`` draws, in its order: the
    cohort mask when sampled, then ``draw_noise`` for all M clients (staged:
    ``stage_noise``), then the faults from their own generators keyed by
    ``gen``'s seed; then ``stage_inputs`` puts the rest on ``device`` (a
    sharded rank's rows of it, ``shard``)."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects

    def stage(gen, t: int, m: int, d: int, device, payload: bool = False) -> RoundInputs:
        mask = cohort.round_mask(gen, m) if sampled else None
        noise = algorithm.stage_noise(algorithm.draw_noise(gen, m, d, device, t), device, t)
        seed = gen.initial_seed()
        faults = fault_masks(fault, seed, m) if injecting else None
        return stage_inputs(algorithm, local_fn, noise, t, m, device, cohort=cohort, fault=fault,
                            mask=mask, faults=faults, seed=seed, payload=payload, shard=shard)

    return stage


def round_body(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn, eval_every: int = 1,
               cohort: CohortSpec | None = None, fault: FaultSpec | None = None, tau: int = 1,
               shard: ShardLayout | None = None):
    """The device half of a round as ``body(w, state, inp, t, batches, eta_l)
    -> (w_next, state, (eta_g, metric, eta_naive, eta_target))``, reading
    only the staged ``inp`` and device memory.  ``t`` decides the round's
    kind alone (whether the eval cadence evaluates it): the scan engine
    captures one graph per kind.  With ``shard`` ``batches`` are the rank's
    slice (``local_cohort``) and every round is the sharded ``masked_round``,
    with its one all-reduce."""
    sampled = cohort is not None and cohort.is_sampled
    injecting = fault is not None and fault.injects
    local = local_caller(local_fn, algorithm)

    def body(w, state, inp: RoundInputs, t: int, client_batches, eta_l):
        if not sampled and not injecting and shard is None:
            deltas = local(w, client_batches, eta_l, 0, state, key=inp.shuffle_key)
            w_next, aux, state = algorithm.apply_round_stateful(None, w, deltas, state,
                                                                noise=inp.noise, t=t)
        else:
            w_next, aux, state = masked_round(algorithm, local_fn, w, state, inp,
                                              cohort if sampled else None, t, client_batches,
                                              eta_l, fault=fault, tau=tau, shard=shard)
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        return w_next, state, (aux.eta_g, metric, aux.eta_naive, aux.eta_target)

    return body


def round_step(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn, eval_every: int = 1,
               cohort: CohortSpec | None = None, fault: FaultSpec | None = None, tau: int = 1):
    """One server round as ``step(w, state, gen, t, batches, eta_l, tap=None)``:
    ``round_stage`` then ``round_body`` (the dense round, or with a
    sampling ``cohort`` or an injecting ``fault`` the masked-moment round).
    The faulted round draws its cohort mask and noise from ``gen`` as the
    sampled round does, and its faults from generators of their own keyed
    by ``gen``'s seed (``fault_masks``); a minibatch trainer's shuffles are
    keyed by that seed too.  ``tap`` (a callable) receives ``(t, payload)``
    after the round, the (12,) ``tap_payload`` on the device; only then does
    the stage put the payload's counts on the device."""
    stage = round_stage(algorithm, local_fn, cohort, fault)
    body = round_body(algorithm, local_fn, eval_fn, eval_every, cohort, fault, tau)

    def step(w, state, gen, t, client_batches, eta_l, tap=None):
        m = tree_leaves(client_batches)[0].shape[0]
        inp = stage(gen, t, m, w.shape[-1], w.device, payload=tap is not None)
        w_next, state_next, out = body(w, state, inp, t, client_batches, eta_l)
        if tap is not None:
            tap(t, tap_payload(algorithm, state, out, inp.counts, -1))
        return w_next, state_next, out

    return step


def _healthy(w_next, eta, eta_max: float) -> bool:
    """The watchdog's one read of the device a round: a finite model and a
    step size that is neither NaN nor above ``eta_max``."""
    ok = torch.isfinite(w_next).all() & (eta.to(w_next.device) <= eta_max)
    return bool(ok)


def run_rounds(step, carry, seed: int, start: int, end: int, client_batches, eta_l, *,
               avg_last: int, fault: FaultSpec | None = None, tap=None):
    """Rounds ``[start, end)`` of ``step`` from ``carry = (w, state, tail)``
    (``tail`` the list of up to ``avg_last`` trailing iterates); round t
    draws from ``round_generator(seed, t)``.

    Returns ``(carry, outs, fault_round)``: ``outs`` one history tuple a
    round run.  With ``fault.watchdog`` a round that trips the watchdog is
    run (its history is kept) but not committed, the loop stops, and
    ``fault_round`` is that round; else it is None.  ``tap`` goes to each
    round's step (its telemetry callback)."""
    w, state, tail = carry
    tail = list(tail)
    watchdog = fault is not None and fault.watchdog
    kw = {} if tap is None else {"tap": tap}
    outs = []
    for t in range(start, end):
        w_next, state_next, out = step(w, state, round_generator(seed, t), t, client_batches,
                                       eta_l, **kw)
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
