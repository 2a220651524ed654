"""FederatedSession: the port's simulation entry point (counterpart of
repro/fedsim/session.py).

    session = FederatedSession(
        algorithm, loss_fn, params, client_batches,
        train=TrainSpec(rounds=50, tau=20, eta_l=0.1),
        cohort=CohortSpec(q=0.1, gather=True),      # optional: sampled rounds
        eval_fn=eval_fn, device="cuda")
    result = session.run(seed=0)
    sweep = session.run_batched([0, 1, 2, 3, 4])    # every field gains a (5,) axis
    report = session.privacy_report(delta=1e-5)

Faults and recovery: ``FederatedSession(..., fault=FaultSpec(dropout=0.3,
straggler=0.2, corrupt=0.02, watchdog=True))`` injects faults every round
and arms the divergence watchdog; ``session.run(seed,
checkpoint_dir="ckpt", checkpoint_every=10,
on_divergence=RecoveryPolicy(max_retries=3))`` saves the run every 10
rounds and rolls a tripped run back to the newest intact checkpoint;
``session.resume("ckpt")`` continues a saved run to ``train.rounds``, bit for
bit the uninterrupted run.

Compressed communication: ``FederatedSession(with_compression(
make_algorithm("cdp-fedexp", ...), RandKAggregation(k=16384)), ...)`` (or
``CountSketchAggregation(width, depth, top_k=, error_feedback=True)``) runs
on every engine; an error-feedback composition's carry is a
``CompressionCarry`` (the residual beside the step's state), which
checkpoints, rollback, ``resume`` and ``run_batched`` keep in bits as they
keep any server state.

DP-SCAFFOLD trains with control variates: ``FederatedSession(
make_algorithm("dp-scaffold", ...), ..., local=LocalSpec(control_variates=True))``.
Clients train by minibatch SGD, FedProx or client momentum with
``local=LocalSpec(batch_size=8, epochs=2, prox_mu=0.01, momentum=0.9)``
(client data with a per-sample axis after the client axis); every round
kind (dense, sampled, gathered, faulted, ``run_batched``, ``resume``) takes it.

Streaming: ``FederatedSession(..., engine=EngineSpec(engine="stream"),
stream=StreamSpec(chunk_clients=128))`` walks each round's cohort in chunks
of 128 clients (``"auto"``: the largest chunk a quarter of the card's
memory holds, resolved when the session is built and recorded on
``session.stream``), one (chunk, d) block of updates live at a time.  Client
data may then be a ``ClientDataSource`` (``fedsim.data``: ``HostArraySource``,
``NpzSource``, ``SyntheticSource``), which stays on the host: each chunk's
rows are fetched and copied to the card ``DataSpec.prefetch`` chunks ahead
(``data=DataSpec(prefetch=2)``), so M is bounded by host storage.

The scan engine, the default (``EngineSpec()``, or ``EngineSpec("scan",
chunk_rounds=10)``), stages each round on the host and replays its body from
a CUDA graph captured once per round kind (``fedsim/scan.py``), in the
eager engine's bits; ``EngineSpec("eager")`` runs the same rounds
uncaptured.  Client sharding: ``FederatedSession(..., shard=ShardSpec(
make_client_mesh()))``, the same call on every rank of a
``torch.distributed`` group (``launch.mesh.make_client_mesh``), splits the
cohort over the ranks under the scan and stream engines: rank r trains and
releases its slice, one all-reduce a round sums the moments, and every rank
returns the same result; rank 0 alone writes checkpoints and tracker events.
Telemetry: ``session.run(seed,
tracker=JsonlTracker("run.jsonl"))`` (also ``resume`` and ``run_batched``,
on every engine) streams one event a round in the JAX package's schema
(``telemetry/tap.py``; ``TelemetrySpec`` sets the ledger's delta and a
profiled window of rounds); a tracked run equals an untracked one in bits.

``params`` may be a flat (d,) vector or a tree of tensors (dicts, lists);
the session flattens a tree once (``flatten_model``), wraps the loss and eval
closures, and unravels ``RunResult.final_w`` / ``last_w`` back to the
caller's structure.  ``params`` and ``client_batches`` may be numpy arrays or
tensors; the session moves them to ``device``, floating data as float32
(a host-resident source's data never moves whole).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import accounting
from repro_torch.core.algorithm import ServerAlgorithm
from repro_torch.device import resolve_device
from repro_torch.fedsim import server as _srv
from repro_torch.fedsim.data import as_data_source
from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import build_cohort_local_fn
from repro_torch.fedsim.scan import ScanEngine
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.specs import (
    CohortSpec,
    DataSpec,
    EngineSpec,
    FaultSpec,
    LocalSpec,
    ShardSpec,
    StreamSpec,
    TelemetrySpec,
    TrainSpec,
)
from repro_torch.launch.mesh import auto_chunk_clients
from repro_torch.telemetry import tap as _tap_mod
from repro_torch.telemetry.trackers import NullTracker, Tracker
from repro_torch.tree import tree_leaves, tree_map, tree_stack

__all__ = ["FederatedSession", "RecoveryPolicy"]


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Recovery of a run that the watchdog tripped.

    ``run(seed, checkpoint_dir=..., on_divergence=RecoveryPolicy(...))`` rolls
    a tripped run back to the newest intact checkpoint, sleeps ``backoff *
    attempt`` seconds (0: no sleep) and runs on from there, at most
    ``max_retries`` times; after that the trip stands in
    ``RunResult.fault_round``.  Every round rolled back was run on client
    data, so the retried rounds join the privacy composition
    (``FederatedSession.privacy_report``).
    """

    max_retries: int = 3
    backoff: float = 0.0

    def __post_init__(self):
        if self.max_retries < 1:
            raise ValueError(
                f"max_retries must be >= 1, got {self.max_retries} "
                "(omit on_divergence to disable recovery)")
        if self.backoff < 0.0:
            raise ValueError(f"backoff must be >= 0, got {self.backoff}")


def _as_tensor(x) -> torch.Tensor:
    """A tensor of ``x`` where it lies (a numpy array as a writable copy)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return torch.as_tensor(x)


def _to_device(x, device) -> torch.Tensor:
    """A tensor on ``device``; floating data as float32, other dtypes kept."""
    x = _as_tensor(x)
    return x.to(device, torch.float32 if x.is_floating_point() else x.dtype)


def _budget_by_name(alg, delta: float, rounds: int, dim: int,
                    q: float) -> accounting.PrivacyReport:
    """The privacy budget of an algorithm without a ``budget`` method, by its
    registry name and attributes, as the JAX package's session dispatches
    for its monolithic classes; a name it does not know is not private."""
    name = alg.name
    if name in ("dp-fedavg-ldp-gauss", "ldp-fedexp-gauss"):
        return accounting.ldp_gaussian_budget(alg.clip_norm, alg.sigma, delta)
    if name in ("dp-fedavg-privunit", "ldp-fedexp-privunit"):
        return accounting.privunit_budget(alg.eps0, alg.eps1, alg.eps2)
    if name == "cdp-fedexp":
        sigma_xi = (alg.sigma_xi if alg.sigma_xi is not None
                    else dim * alg.sigma**2 / alg.num_clients)
        return accounting.cdp_budget(alg.clip_norm, alg.sigma, alg.num_clients, rounds, delta,
                                     sigma_xi=sigma_xi, sampling_q=q)
    if name in ("dp-fedavg-cdp", "dp-fedadam-cdp"):
        return accounting.cdp_budget(alg.clip_norm, alg.sigma, alg.num_clients, rounds, delta,
                                     sampling_q=q)
    if name == "cdp-fedexp-adaptive-clip":
        from repro_torch.core.compose import CentralGaussian
        return CentralGaussian(z_mult=alg.z_mult, num_clients=alg.num_clients).budget(
            delta, rounds=rounds, dim=dim, sampling_q=q, with_numerator=True)
    raise ValueError(f"{name!r} is not a private algorithm")


class FederatedSession:
    """A reusable federated run bound to declarative specs."""

    def __init__(self, algorithm: ServerAlgorithm, loss_fn: Callable, params: Any,
                 client_batches, *, train: TrainSpec, local: LocalSpec | None = None,
                 engine: EngineSpec = EngineSpec(), shard: ShardSpec = ShardSpec(),
                 cohort: CohortSpec | None = None,
                 fault: FaultSpec | None = None, stream: StreamSpec = StreamSpec(),
                 data: DataSpec | None = None, telemetry: TelemetrySpec = TelemetrySpec(),
                 eval_fn: Callable | None = None, num_clients: int | None = None,
                 device="cuda"):
        """Bind (algorithm, loss, model, client data) to the specs.

        Args:
          algorithm: a ``ServerAlgorithm`` (``make_algorithm(...)`` or a
            ``compose_algorithm(...)`` composition).
          loss_fn: per-client loss ``loss_fn(params, client_batch) -> scalar``
            on the caller's parameter structure.
          params: initial model — a flat (d,) vector, or a tree of tensors;
            a (S, d) stack of flat vectors for ``run_batched(batched_w0=True)``.
          client_batches: tree of per-client data, client axis leading (after
            a seed axis for ``run_batched(batched_data=True)``), or a
            ``ClientDataSource``: an ``ArraySource`` is its data on the device,
            bit for bit; the host, npz and synthetic sources stay on the host
            and need ``engine="stream"``.
          train: rounds, tau, eta_l, iterate averaging, eval cadence.
          local: how clients train (``LocalSpec``): None or the default is
            full-batch GD; ``batch_size``/``epochs``, ``prox_mu`` and
            ``momentum`` the spec trainer; ``control_variates=True``
            SCAFFOLD's steps, which a control-variate algorithm
            (``dp-scaffold``) needs and only it takes.
          engine: how the round loop runs (``EngineSpec``: "scan", the
            default, for rounds replayed from CUDA graphs, "eager", or
            "stream" for rounds walked in client chunks).
          shard: where the cohort lives (``ShardSpec``): a 1-D client mesh
            splits it over the ranks of a ``torch.distributed`` group (the
            scan and stream engines); every rank builds the session on the
            whole cohort and keeps its slice on its device.
          cohort: who participates each round (``CohortSpec``); None or
            ``CohortSpec()`` is full participation.
          fault: faults injected each round and the divergence watchdog
            (``FaultSpec``); None or ``FaultSpec()`` is a fault-free run.
          stream: the streamed round's client chunk (``StreamSpec``); a
            non-default spec needs ``engine="stream"``.
          data: where the client data lives and the prefetch depth of a
            host-resident source (``DataSpec``); derived from
            ``client_batches`` when omitted, and refused when its kind
            contradicts them.
          telemetry: how a tracked run is observed (``TelemetrySpec``: the
            ledger's delta, a profiled window of rounds); it never changes
            what a round computes.
          eval_fn: optional metric closure ``eval_fn(params) -> scalar``.
          num_clients: the cohort size M, needed only when the client axis
            is not leaf axis 0 (``run_batched(batched_data=True)``).
          device: where the run executes; "cuda" (the default) raises when no
            card is present — the CPU runs only when asked for.
        """
        self.algorithm = algorithm
        self.train = train
        self.local = local
        self._check_local()
        self.engine = engine
        self.shard = shard
        self.telemetry = telemetry
        self._scan = None
        self.cohort = cohort
        # FaultSpec() is the fault-free round loop, bit for bit
        self.fault = fault if fault is not None and fault.is_active else None
        # rounds run again after a rollback (recovery); privacy_report
        # composes them too
        self._rounds_retried = 0
        # test hook: ``(carry, attempt) -> carry`` applied before the first
        # round of each attempt of ``run``, so that a test can plant a
        # divergence in attempt 0 only and hold the recovered run to an
        # unkilled one
        self._inject_divergence = None
        self.device = resolve_device(device)
        if engine.engine != "stream" and stream != StreamSpec():
            raise ValueError(
                "a non-default StreamSpec requires engine='stream' (EngineSpec(engine='stream')); "
                f"it would be silently ignored under engine={engine.engine!r}")
        self.stream = stream
        source = as_data_source(client_batches)
        if source is not None and source.kind == "device":
            client_batches, source = source.batches, None
        kind = "device" if source is None else source.kind
        if data is None:
            data = DataSpec(kind=kind)
        elif data.kind != kind:
            raise ValueError(
                f"DataSpec(kind={data.kind!r}) contradicts the client data actually passed "
                f"({kind!r}); drop data= (the kind is derived) or pass the matching "
                "ClientDataSource")
        self.data = data
        if source is not None:
            if engine.engine != "stream":
                raise ValueError(
                    f"a {kind!r} ClientDataSource requires engine='stream' (the eager engine "
                    "trains on device-resident batches); pass EngineSpec(engine='stream') or "
                    "stage the data yourself and pass tensors")
            if shard.mesh is not None:
                raise ValueError(
                    "host-resident sources stream on a single device (chunk "
                    "staging does not compose with the clients mesh yet); "
                    "drop ShardSpec or pass device-resident batches")
            if self.fault is not None and self.fault.injects:
                raise ValueError(
                    "fault injection requires device-resident batches; drop FaultSpec or pass "
                    "tensors")
            # the source is the round's data: its rows reach the card a chunk at a time
            self.client_batches = source
            self.num_clients = source.num_clients
        else:
            # a sharded rank moves only its slice to the device (``_local_batches``)
            self.client_batches = tree_map(
                _as_tensor if shard.mesh is not None else (lambda x: _to_device(x, self.device)),
                client_batches)
            self.num_clients = (num_clients if num_clients is not None
                                else tree_leaves(self.client_batches)[0].shape[0])
        self._validate_cohort(self.num_clients)
        params = tree_map(lambda x: _to_device(x, self.device), params)
        if isinstance(params, torch.Tensor):
            self._w0 = params if params.dim() == 2 else params.reshape(-1)
            self._unravel = None
            self.loss_fn, self.eval_fn = loss_fn, eval_fn
        else:
            self._w0, self._unravel = flatten_model(params)
            unravel = self._unravel
            self.loss_fn = lambda wf, batch: loss_fn(unravel(wf), batch)
            self.eval_fn = None if eval_fn is None else (lambda wf: eval_fn(unravel(wf)))
        # the trainer: full-batch GD, the spec trainer, or SCAFFOLD's steps on
        # the context ``(c_i rows, c)`` that the round appends; ``steps=`` the
        # stragglers' per-client cutoffs
        self._local_fn = build_cohort_local_fn(self.loss_fn, local, train.tau)
        if engine.engine == "stream" and self.stream.is_auto:
            # the largest chunk the card's budget holds, recorded for the caller
            self.stream = StreamSpec(chunk_clients=auto_chunk_clients(
                self.dim, self._client_bytes(), device=self.device))
        self._layout = None
        if shard.mesh is not None:
            gathered = self.cohort is not None and self.cohort.is_sampled and self.cohort.gather
            # the stream engine's dense slices are whole chunks (JAX's
            # chunk_cohort(..., n_shards=)); otherwise pad_cohort's
            multiple = (self._stream_chunk() if engine.engine == "stream" and not gathered
                        else 1)
            self._layout = _srv.shard_layout(self.num_clients, shard.n_shards, shard.rank,
                                             shard.group, multiple)
        self._local_batches = None    # the rank's slice, made at its first run

    def _check_local(self) -> None:
        """Refuse a control-variate algorithm without the control-variate
        trainer, and the other way round."""
        local = self.local
        wants_ctx = bool(getattr(self.algorithm, "uses_local_context", False))
        has_cv = local is not None and local.control_variates
        if wants_ctx and not has_cv:
            raise ValueError(
                f"{self.algorithm.name!r} trains with per-client control variates; pass "
                "local=LocalSpec(control_variates=True) so the trainer consumes the (c_i, c) "
                "context")
        if has_cv and not wants_ctx:
            raise ValueError(
                "LocalSpec(control_variates=True) needs a control-variate algorithm (e.g. "
                f"make_algorithm('dp-scaffold', ...)); {self.algorithm.name!r} supplies no "
                "local context")

    def _validate_cohort(self, m: int) -> None:
        """Refuse a cohort or per-client tables that do not fit M clients."""
        c = self.cohort
        if c is not None and c.size is not None and not c.replace and c.size > m:
            raise ValueError(f"CohortSpec.size={c.size} exceeds the {m}-client cohort "
                             "(without replacement)")
        agg = getattr(self.algorithm, "aggregation", None)
        if getattr(agg, "is_weighted", False) and len(agg.weights) != m:
            raise ValueError(
                f"WeightedAggregation carries {len(agg.weights)} weights for a {m}-client "
                "cohort; weights are indexed by global client index and must match exactly")
        eps = getattr(getattr(self.algorithm, "mechanism", None), "epsilons", None)
        if eps is not None and len(eps) != m:
            raise ValueError(
                f"{self.algorithm.name!r} carries {len(eps)} per-client epsilons for a "
                f"{m}-client cohort; they are indexed by global client index and must match")
        alg_m = getattr(self.algorithm, "num_clients", None)
        if getattr(self.algorithm, "uses_local_context", False) and alg_m != m:
            raise ValueError(
                f"{self.algorithm.name!r} carries a {alg_m}-client variate table for a "
                f"{m}-client cohort; num_clients indexes the per-client state by global "
                "client index and must match")

    def _stream_chunk(self) -> int:
        """The streamed round's chunk: a chunk past M is the one-chunk grid either way."""
        return min(self.stream.chunk_clients, max(1, self.num_clients))

    def _local_of(self, client_batches):
        """A sharded rank's slice of the cohort ``client_batches`` on the device."""
        return tree_map(lambda x: _to_device(x, self.device),
                        _srv.local_cohort(client_batches, self._layout, self.device))

    def _check_shard(self) -> None:
        """Refuse a client mesh where the JAX package refuses it."""
        if self.shard.mesh is not None and self.engine.engine == "eager":
            raise ValueError("client sharding requires engine='scan'")

    def _barrier(self) -> None:
        """Wait for every rank of the client mesh (a no-op unsharded)."""
        if self.shard.mesh is not None:
            torch.distributed.barrier(group=self.shard.group)

    def _from_rank0(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank of the client mesh (``flag`` unsharded)."""
        if self.shard.mesh is None:
            return flag
        group = self.shard.group
        t = torch.tensor([int(flag)], device=self.device)
        torch.distributed.broadcast(t, src=torch.distributed.get_global_rank(group, 0),
                                    group=group)
        return bool(t.item())

    @property
    def dim(self) -> int:
        """Flat model dimension d (after any tree flatten)."""
        return self._w0.shape[-1]

    def _client_bytes(self) -> int:
        """Bytes of one client's data (the auto chunk's sizing term): one
        fetched row of a source, else the device data's bytes over M."""
        if self.data.kind != "device":
            rows = self.client_batches.fetch(np.zeros((1,), np.int64))
            return int(sum(np.asarray(x).nbytes for x in tree_leaves(rows)))
        total = sum(x.numel() * x.element_size() for x in tree_leaves(self.client_batches))
        return int(total // max(1, self.num_clients))

    def _restore(self, w):
        return w if self._unravel is None else self._unravel(w)

    def run(self, seed: int, *, tracker: Tracker | None = None,
            checkpoint_dir: str | None = None, checkpoint_every: int | None = None,
            on_divergence: RecoveryPolicy | None = None) -> RunResult:
        """Run all ``train.rounds`` rounds from round 0; round t draws its
        randomness from ``round_generator(seed, t)``.

        ``tracker`` receives one event a round (eta, the metric on its
        cadence, clip, sigma, participants, fault totals, wall time, the
        cumulative privacy ledger; ``telemetry/tap.py``), rollbacks and
        profile windows, on every engine; the run equals the untracked one
        in bits.  None or a ``NullTracker`` reads nothing for it.

        ``checkpoint_dir`` saves the whole state of the run (model, server
        state, the ``avg_last`` tail, histories, seed) every
        ``checkpoint_every`` rounds and at the end; ``resume`` continues it
        bit for bit.  ``on_divergence`` (needs ``checkpoint_dir`` and
        ``FaultSpec(watchdog=True)``) rolls a tripped run back to the newest
        intact checkpoint and runs on (``RecoveryPolicy``); the retried
        rounds join ``privacy_report``.
        """
        if self._w0.dim() == 2:
            raise ValueError(
                f"params of shape {tuple(self._w0.shape)} is a stack of initial models; run it "
                "with run_batched(seeds, batched_w0=True), or pass a flat (d,) vector or a tree")
        self._check_shard()
        if checkpoint_every is not None and checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir (nothing would be saved)")
        if on_divergence is not None:
            if self.fault is None or not self.fault.watchdog:
                raise ValueError("on_divergence requires FaultSpec(watchdog=True): without "
                                 "the watchdog a diverged run never trips")
            if checkpoint_dir is None:
                raise ValueError("on_divergence requires checkpoint_dir (rollback needs a "
                                 "checkpoint target)")
        return self._tracked(tracker, "run", 0, lambda sess: self._run_loop(
            seed, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            on_divergence=on_divergence, tap=sess))

    def resume(self, checkpoint_dir: str, *, checkpoint_every: int | None = None,
               tracker: Tracker | None = None) -> RunResult:
        """Continue the newest intact checkpoint in ``checkpoint_dir`` up to
        ``train.rounds`` and return the whole ``RunResult`` (the histories
        of the rounds before the checkpoint included): bit for bit what the
        uninterrupted run returns.  A ``tracker`` is told the resumed round
        (``start_phase("resume", step)``) and gets the resumed rounds' events
        only; its ledger counts from round 0."""
        self._check_shard()
        step, seed, carry, hist = self._load(checkpoint_dir)
        if step > self.train.rounds:
            raise ValueError(f"checkpoint is at round {step}, past this session's "
                             f"train.rounds={self.train.rounds}")
        return self._tracked(tracker, "resume", step, lambda sess: self._run_loop(
            seed, start=step, carry=carry, hist=hist, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, tap=sess))

    # -- telemetry --------------------------------------------------------------

    @staticmethod
    def _tap_on(tracker) -> bool:
        """Whether a tracker is attached: None or a ``NullTracker`` is off,
        and then no round reads anything for telemetry."""
        return tracker is not None and not isinstance(tracker, NullTracker)

    def _ledger_fn(self):
        """The cumulative privacy ledger as ``executed_rounds -> PrivacyReport``,
        or None: off by ``TelemetrySpec(ledger_delta=None)``, or for an
        algorithm without a budget (probed once, at one round)."""
        delta = self.telemetry.ledger_delta
        if delta is None:
            return None
        try:
            self._budget_at(delta, 1)
        except (ValueError, AttributeError, TypeError):
            return None
        return lambda executed: self._budget_at(delta, executed)

    def _bytes_per_round(self) -> float | None:
        """The modeled communication of a round, ``4 * comm_floats(d)``
        (static for a spec), or None."""
        comm = getattr(self.algorithm, "comm_floats", None)
        if comm is None:
            return None
        try:
            return 4.0 * float(comm(self.dim))
        except (TypeError, ValueError):
            return None

    def _tap_session(self, tracker, start_round: int) -> _tap_mod.TapSession:
        return _tap_mod.TapSession(
            tracker, start_round=start_round, ledger_fn=self._ledger_fn(),
            faults_active=self.fault is not None and self.fault.injects,
            bytes_per_round=self._bytes_per_round(), shard=self.shard.rank)

    def _tracked(self, tracker, phase: str, step: int, fn):
        """``fn(tap_session)`` with the tracker's tap installed (``fn(None)``
        when no tracker is attached), the tracker finished after."""
        if not self._tap_on(tracker):
            return fn(None)
        sess = self._tap_session(tracker, step)
        _tap_mod.install(sess)
        tracker.start_phase(phase, step)
        try:
            return fn(sess)
        finally:
            _tap_mod.uninstall()
            tracker.finish()

    def spec_identity(self) -> str:
        """One line naming this session's specs, the JAX package's string for
        the same specs: deterministic across processes (the mesh contributes
        its axis and size)."""
        parts = [
            f"algorithm={self.algorithm.name}",
            f"train={self.train!r}",
            f"local={(self.local if self.local is not None else LocalSpec())!r}",
            f"engine={self.engine!r}",
            f"stream={self.stream!r}",
            f"cohort={(self.cohort if self.cohort is not None else CohortSpec())!r}",
            f"fault={(self.fault if self.fault is not None else FaultSpec())!r}",
            f"data={self.data!r}",
            f"telemetry={self.telemetry!r}",
            self.shard.describe(),
        ]
        return " | ".join(parts)

    def _step(self):
        t = self.train
        if self.engine.engine == "stream":
            return _srv.stream_round_step(self.algorithm, self._local_fn, self.eval_fn,
                                          t.eval_every, self.cohort, self.fault, t.tau,
                                          chunk_clients=self._stream_chunk(),
                                          num_clients=self.num_clients,
                                          prefetch=self.data.prefetch, shard=self._layout)
        return _srv.round_step(self.algorithm, self._local_fn, self.eval_fn, t.eval_every,
                               self.cohort, self.fault, t.tau)

    def _finish(self, result: RunResult) -> RunResult:
        result.final_w = self._restore(result.final_w)
        result.last_w = self._restore(result.last_w)
        return result

    # -- checkpoints and rollback ---------------------------------------------

    def _save(self, directory: str, step: int, seed: int, carry, hist) -> None:
        """Checkpoint the carry ``(w, state, tail)`` and the histories at
        ``step``.  Under sharding every rank holds the same carry: rank 0
        writes, and every rank waits for the write."""
        if self.shard.rank == 0:
            w, state, tail = carry
            tail = torch.stack(tail) if tail else w.new_zeros((0,) + tuple(w.shape))
            ckpt.save_checkpoint(directory, step, {"carry": (w, state, tail), "hist": hist},
                                 extra={"seed": int(seed), "algorithm": self.algorithm.name,
                                        "rounds_total": self.train.rounds})
        self._barrier()

    def _carry_template(self, step: int):
        """A carry of this session's structure at ``step``: the tail holds
        ``min(step, avg_last)`` iterates."""
        w = self._w0
        return (torch.zeros_like(w), self.algorithm.init_state(w),
                w.new_zeros((min(step, self.train.avg_last),) + tuple(w.shape)))

    def _load(self, directory: str, *, retries: int = 0, backoff: float = 0.0):
        """The newest intact checkpoint as ``(step, seed, carry, hist)``, on
        the session's device; corrupt ones are skipped, and a directory
        without a checkpoint raises FileNotFoundError."""
        def template(step):
            return {"carry": self._carry_template(step),
                    "hist": tuple(torch.zeros(step, device=self.device) for _ in range(4))}

        step, payload, meta = ckpt.load_latest_intact(directory, template, retries=retries,
                                                      backoff=backoff)
        if meta.get("algorithm") not in (None, self.algorithm.name):
            raise ValueError(f"checkpoint was written by algorithm {meta['algorithm']!r}, "
                             f"this session runs {self.algorithm.name!r}")
        w, state, tail = payload["carry"]
        return step, int(meta["seed"]), (w, state, list(tail.unbind(0))), payload["hist"]

    def _chunk_bounds(self, start: int, every: int | None):
        """``[(s, e)]`` spans of rounds from ``start`` to ``train.rounds``,
        split on the scan engine's chunk grid (anchored at ``start``), where
        a checkpoint is due (anchored at round 0) and at the edges of the
        profiled window, as the JAX package splits its chunks."""
        rounds = self.train.rounds
        stops = {rounds}
        if self.engine.engine == "scan":
            chunk = self.engine.chunk_rounds or max(1, rounds - start)
            stops.update(range(start + chunk, rounds, chunk))
        if every:
            stops.update(b for b in range(every, rounds, every) if b > start)
        profile = self.telemetry.profile_rounds
        if profile is not None:
            stops.update(e for e in (profile[0], min(profile[1], rounds)) if start < e < rounds)
        edges = [start] + sorted(stops)
        return [(s, e) for s, e in zip(edges[:-1], edges[1:]) if s < e]

    def _scan_engine(self) -> ScanEngine:
        """The session's scan engine, made at its first chunk and kept (its
        graphs serve every later run, seed and resume)."""
        if self._scan is None:
            t = self.train
            self._scan = ScanEngine(
                self.algorithm, self._local_fn, self.eval_fn, eval_every=t.eval_every,
                cohort=self.cohort, fault=self.fault, tau=t.tau, avg_last=t.avg_last,
                eta_l=t.eta_l, unroll=self.engine.scan_unroll, num_clients=self.num_clients,
                device=self.device, chunk_cap=min(t.rounds, self.engine.chunk_rounds or t.rounds),
                shard=self._layout)
        return self._scan

    def _profile_start(self, tap, s: int):
        """Start the profiled window (``TelemetrySpec.profile_rounds``) at round ``s``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        if tap is not None:
            tap.profile_event("start", s, self.telemetry.profile_dir)
        return prof

    def _profile_stop(self, prof, tap, e: int) -> None:
        """Stop the profiled window at round ``e`` and write its trace to
        ``profile_dir/trace_<e>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = self.telemetry.profile_dir
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_{e}.json"))
        if tap is not None:
            tap.profile_event("stop", e, out)

    def _run_loop(self, seed: int, *, start: int = 0, carry=None, hist=None,
                  checkpoint_dir=None, checkpoint_every=None,
                  on_divergence: RecoveryPolicy | None = None, w0=None,
                  client_batches=None, tap: _tap_mod.TapSession | None = None) -> RunResult:
        """The round loop with checkpoints and rollback (the JAX package's
        ``_run_scan`` loop), a chunk at a time: the eager and streamed
        engines' rounds (``run_rounds``) or the scan engine's replays
        (``ScanEngine.run_chunk``).  ``carry`` None starts from ``w0``; ``w0``
        / ``client_batches`` None are the session's own.  ``tap`` (the
        tracked run's ``TapSession``) gets each round's payload."""
        t = self.train
        policy = on_divergence
        scan = self.engine.engine == "scan"
        step = None if scan else self._step()
        w0 = self._w0 if w0 is None else w0
        if self._layout is not None and client_batches is not None:
            client_batches = self._local_of(client_batches)
        elif self._layout is not None:
            if self._local_batches is None:
                self._local_batches = self._local_of(self.client_batches)
            client_batches = self._local_batches
        elif client_batches is None:
            client_batches = self.client_batches
        if carry is None:
            carry = (w0, self.algorithm.init_state(w0), [])
            hist = _srv.stack_outs([], self.device)
        if policy is not None:
            # a rollback target must exist before any round runs; rank 0
            # decides, so every rank calls ``_save`` (and its barrier) or none
            missing = self.shard.rank == 0 and ckpt.latest_step(checkpoint_dir) is None
            if self._from_rank0(missing):
                self._save(checkpoint_dir, start, seed, carry, hist)
        emit = None if tap is None else (lambda r, payload: tap.emit(r, payload.cpu().numpy()))
        profile = self.telemetry.profile_rounds
        prof = None
        bounds = self._chunk_bounds(start, checkpoint_every)
        retries, idx, fault_round = 0, 0, None
        inject_pending = self._inject_divergence is not None
        while idx < len(bounds):
            s, e = bounds[idx]
            if inject_pending:
                carry = self._inject_divergence(carry, retries)
                inject_pending = False
            if profile is not None and s == profile[0] and prof is None:
                prof = self._profile_start(tap, s)
            if scan:
                carry, chunk_hist, fault_t, rows, times = self._scan_engine().run_chunk(
                    carry, seed, s, e, client_batches, timing=tap is not None)
                if tap is not None:
                    for r, (row, dt) in enumerate(zip(rows.cpu().numpy(), times)):
                        tap.emit(s + r, row, dt)
            else:
                carry, outs, fault_t = _srv.run_rounds(step, carry, seed, s, e, client_batches,
                                                       t.eta_l, avg_last=t.avg_last,
                                                       fault=self.fault, tap=emit)
                chunk_hist = _srv.stack_outs(outs, self.device)
            if prof is not None and (e >= min(profile[1], t.rounds) or fault_t is not None):
                self._profile_stop(prof, tap, e)
                prof = None
            if fault_t is not None and policy is not None and retries < policy.max_retries:
                # roll back: the rounds past the checkpoint were run (their
                # releases happened) and run again, so they join the budget
                retries += 1
                if policy.backoff > 0.0:
                    time.sleep(policy.backoff * retries)
                back, seed, carry, hist = self._load(checkpoint_dir, retries=2,
                                                     backoff=policy.backoff)
                self._rounds_retried += fault_t + 1 - back
                if tap is not None:
                    tap.rollback(back, fault_t, retries)
                bounds, idx = self._chunk_bounds(back, checkpoint_every), 0
                inject_pending = self._inject_divergence is not None
                continue
            hist = tuple(torch.cat([h, n]) for h, n in zip(hist, chunk_hist))
            if fault_t is not None:
                fault_round = fault_t
                break
            # a tripped carry is never saved: the rollback target stays the
            # last healthy state
            if checkpoint_dir is not None and (
                    e == t.rounds or (checkpoint_every and e % checkpoint_every == 0)):
                self._save(checkpoint_dir, e, seed, carry, hist)
            idx += 1
        return self._finish(_srv.assemble_result(carry, hist, t.rounds, fault_round))

    def run_batched(self, seeds, *, batched_w0: bool = False,
                    batched_data: bool = False, tracker: Tracker | None = None) -> RunResult:
        """A sweep over ``seeds``: every ``RunResult`` field gains a leading
        (S,) axis, and slice s equals ``run(seeds[s])`` bit for bit.

        The seeds run one after another through the round loop, as the JAX
        package's streamed sweep does (the scan engine's graphs serve every
        seed).  ``batched_w0`` / ``batched_data``: the initial model (a (S,
        d) stack of flat vectors) / every leaf of the client data carries a
        leading seed axis, and seed s runs on its slice.  A ``tracker`` gets
        each seed's events afterwards from its histories, through a per-seed
        sub-tracker (the JAX package's replay: its schema without wall time
        or fault fields).
        """
        self._check_shard()
        if self.fault is not None:
            raise ValueError(
                "run_batched has no fault-injection/watchdog support; run seeds through run() "
                "when a FaultSpec is active (a silently fault-free sweep would misreport the "
                "fault model)")
        seeds = [int(s) for s in seeds]
        if self.engine.engine == "stream" and (batched_w0 or batched_data):
            raise ValueError(
                "run_batched(engine='stream') sweeps the seeds one after another through the "
                "streamed round; per-seed w0/data axes are not supported — loop run() with "
                "per-seed sessions instead")
        if batched_w0 and self._unravel is not None:
            raise ValueError(
                "batched_w0 with a tree model is ambiguous (the seed axis would be raveled "
                "into the parameters); stack flat vectors via flatten_model and unravel per "
                "seed instead")
        if batched_w0 and (self._w0.dim() != 2 or self._w0.shape[0] != len(seeds)):
            raise ValueError(f"batched_w0 needs a ({len(seeds)}, d) stack of initial models, "
                             f"got shape {tuple(self._w0.shape)}")
        if batched_data:
            leaf = tree_leaves(self.client_batches)[0]
            if leaf.shape[0] != len(seeds):
                raise ValueError(f"batched_data needs a leading axis of {len(seeds)} seeds on "
                                 f"every leaf, got shape {tuple(leaf.shape)}")
            self._validate_cohort(leaf.shape[1])
        else:
            self._validate_cohort(self.num_clients)
        results = [self._run_loop(seed, w0=self._w0[i] if batched_w0 else None,
                                  client_batches=tree_map(lambda x, i=i: x[i],
                                                          self.client_batches)
                                  if batched_data else None)
                   for i, seed in enumerate(seeds)]

        result = RunResult(**{f.name: tree_stack([getattr(r, f.name) for r in results])
                              for f in dataclasses.fields(RunResult) if f.name != "fault_round"})
        if self._tap_on(tracker):
            self._replay_batched(tracker, result)
        return result

    def _replay_batched(self, tracker: Tracker, result: RunResult) -> None:
        """Each seed's events from its histories, through ``tracker.sub(i)``
        (the JAX package's ``_replay_batched``)."""
        ledger = self._ledger_fn()
        bytes_pr = self._bytes_per_round()
        etas, metrics, naives, targets = (np.asarray(h.cpu()) for h in (
            result.eta_history, result.metric_history, result.eta_naive_history,
            result.eta_target_history))
        for i in range(etas.shape[0]):
            sub = tracker.sub(i)
            sub.start_phase("replay", 0)
            for t in range(etas.shape[1]):
                event = {"eta": float(etas[i, t]), "eta_naive": float(naives[i, t]),
                         "eta_target": float(targets[i, t])}
                if bytes_pr is not None:
                    event["bytes_per_round"] = bytes_pr
                if math.isfinite(float(metrics[i, t])):
                    event["metric"] = float(metrics[i, t])
                if ledger is not None:
                    rep = ledger(t + 1)
                    event.update(ledger_rounds=t + 1, mu=float(rep.mu),
                                 eps=float(rep.eps_numerical), eps_rdp=float(rep.eps_rdp))
                sub.log(t, event)
        tracker.finish()

    def privacy_report(self, delta: float) -> accounting.PrivacyReport:
        """Privacy budget of this session's full run; raises for non-private
        algorithms.  The cohort's per-round sampling rate feeds the
        subsampled-GDP accounting of CDP releases (``accounting.cdp_budget``);
        LDP guarantees are per release and do not amplify.

        Faults count both ways: the per-round rate is the realized
        participation q (1 - dropout) (a dropped client's data never reaches
        the release), and every round run again by ``run(on_divergence=...)``
        joins the composition; call it after ``run`` to fold that run's
        retries in."""
        return self._budget_at(delta, self.train.rounds + self._rounds_retried)

    def _budget_at(self, delta: float, rounds: int) -> accounting.PrivacyReport:
        """``privacy_report`` at an explicit count of executed rounds: the
        telemetry ledger calls it every round with the rounds run so far
        (retries included), so its last entry equals ``privacy_report``.

        The algorithm's own ``budget`` when it has one (the compositions,
        the monolithic classes, DP-SCAFFOLD); else the JAX package's
        dispatch on the registry name (``_budget_by_name``)."""
        alg = self.algorithm
        q = 1.0 if self.cohort is None else self.cohort.sampling_rate(self.num_clients)
        dropout = self.fault.dropout if self.fault is not None and self.fault.injects else 0.0
        q = accounting.realized_participation(q, dropout)
        if hasattr(alg, "budget"):
            return alg.budget(delta, rounds=rounds, dim=self.dim, sampling_q=q)
        return _budget_by_name(alg, delta, rounds, self.dim, q)
