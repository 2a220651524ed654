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

``params`` may be a flat (d,) vector or a tree of tensors (dicts, lists);
the session flattens a tree once (``flatten_model``), wraps the loss and eval
closures, and unravels ``RunResult.final_w`` / ``last_w`` back to the
caller's structure.  ``params`` and ``client_batches`` may be numpy arrays or
tensors; the session moves them to ``device``, floating data as float32
(a host-resident source's data never moves whole).
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.specs import (
    CohortSpec,
    DataSpec,
    EngineSpec,
    FaultSpec,
    LocalSpec,
    StreamSpec,
    TrainSpec,
)
from repro_torch.launch.mesh import auto_chunk_clients
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


def _to_device(x, device) -> torch.Tensor:
    """A tensor on ``device``; floating data as float32, other dtypes kept."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))  # a writable copy
    x = torch.as_tensor(x)
    return x.to(device, torch.float32 if x.is_floating_point() else x.dtype)


class FederatedSession:
    """A reusable federated run bound to declarative specs."""

    def __init__(self, algorithm: ServerAlgorithm, loss_fn: Callable, params: Any,
                 client_batches, *, train: TrainSpec, local: LocalSpec | None = None,
                 engine: EngineSpec = EngineSpec(), cohort: CohortSpec | None = None,
                 fault: FaultSpec | None = None, stream: StreamSpec = StreamSpec(),
                 data: DataSpec | None = None, eval_fn: Callable | None = None,
                 num_clients: int | None = None, device="cuda"):
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
          engine: how the round loop runs (``EngineSpec``: "eager", or
            "stream" for rounds walked in client chunks).
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
            if self.fault is not None and self.fault.injects:
                raise ValueError(
                    "fault injection requires device-resident batches; drop FaultSpec or pass "
                    "tensors")
            # the source is the round's data: its rows reach the card a chunk at a time
            self.client_batches = source
            self.num_clients = source.num_clients
        else:
            self.client_batches = tree_map(lambda x: _to_device(x, self.device), client_batches)
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

    def run(self, seed: int, *, checkpoint_dir: str | None = None,
            checkpoint_every: int | None = None,
            on_divergence: RecoveryPolicy | None = None) -> RunResult:
        """Run all ``train.rounds`` rounds from round 0; round t draws its
        randomness from ``round_generator(seed, t)``.

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
        if checkpoint_every is not None and checkpoint_dir is None:
            raise ValueError("checkpoint_every requires checkpoint_dir (nothing would be saved)")
        if on_divergence is not None:
            if self.fault is None or not self.fault.watchdog:
                raise ValueError("on_divergence requires FaultSpec(watchdog=True): without "
                                 "the watchdog a diverged run never trips")
            if checkpoint_dir is None:
                raise ValueError("on_divergence requires checkpoint_dir (rollback needs a "
                                 "checkpoint target)")
        return self._run_loop(seed, checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every, on_divergence=on_divergence)

    def resume(self, checkpoint_dir: str, *, checkpoint_every: int | None = None) -> RunResult:
        """Continue the newest intact checkpoint in ``checkpoint_dir`` up to
        ``train.rounds`` and return the whole ``RunResult`` (the histories
        of the rounds before the checkpoint included): bit for bit what the
        uninterrupted run returns."""
        step, seed, carry, hist = self._load(checkpoint_dir)
        if step > self.train.rounds:
            raise ValueError(f"checkpoint is at round {step}, past this session's "
                             f"train.rounds={self.train.rounds}")
        return self._run_loop(seed, start=step, carry=carry, hist=hist,
                              checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)

    def _step(self):
        t = self.train
        if self.engine.engine == "stream":
            # a chunk past M is the one-chunk grid either way
            chunk = min(self.stream.chunk_clients, max(1, self.num_clients))
            return _srv.stream_round_step(self.algorithm, self._local_fn, self.eval_fn,
                                          t.eval_every, self.cohort, self.fault, t.tau,
                                          chunk_clients=chunk, num_clients=self.num_clients,
                                          prefetch=self.data.prefetch)
        return _srv.round_step(self.algorithm, self._local_fn, self.eval_fn, t.eval_every,
                               self.cohort, self.fault, t.tau)

    def _finish(self, result: RunResult) -> RunResult:
        result.final_w = self._restore(result.final_w)
        result.last_w = self._restore(result.last_w)
        return result

    # -- checkpoints and rollback ---------------------------------------------

    def _save(self, directory: str, step: int, seed: int, carry, hist) -> str:
        """Checkpoint the carry ``(w, state, tail)`` and the histories at ``step``."""
        w, state, tail = carry
        tail = torch.stack(tail) if tail else w.new_zeros((0,) + tuple(w.shape))
        return ckpt.save_checkpoint(directory, step, {"carry": (w, state, tail), "hist": hist},
                                    extra={"seed": int(seed), "algorithm": self.algorithm.name,
                                           "rounds_total": self.train.rounds})

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
        split where a checkpoint is due."""
        rounds = self.train.rounds
        stops = {rounds}
        if every:
            stops.update(b for b in range(every, rounds, every) if b > start)
        edges = [start] + sorted(stops)
        return [(s, e) for s, e in zip(edges[:-1], edges[1:]) if s < e]

    def _run_loop(self, seed: int, *, start: int = 0, carry=None, hist=None,
                  checkpoint_dir=None, checkpoint_every=None,
                  on_divergence: RecoveryPolicy | None = None, w0=None,
                  client_batches=None) -> RunResult:
        """The round loop with checkpoints and rollback (the JAX package's
        ``_run_scan`` loop on the eager rounds).  ``carry`` None starts from
        ``w0``; ``w0`` / ``client_batches`` None are the session's own."""
        t = self.train
        policy = on_divergence
        step = self._step()
        w0 = self._w0 if w0 is None else w0
        client_batches = self.client_batches if client_batches is None else client_batches
        if carry is None:
            carry = (w0, self.algorithm.init_state(w0), [])
            hist = _srv.stack_outs([], self.device)
        if policy is not None and ckpt.latest_step(checkpoint_dir) is None:
            # a rollback target must exist before any round runs
            self._save(checkpoint_dir, start, seed, carry, hist)
        bounds = self._chunk_bounds(start, checkpoint_every)
        retries, idx, fault_round = 0, 0, None
        inject_pending = self._inject_divergence is not None
        while idx < len(bounds):
            s, e = bounds[idx]
            if inject_pending:
                carry = self._inject_divergence(carry, retries)
                inject_pending = False
            carry, outs, fault_t = _srv.run_rounds(step, carry, seed, s, e, client_batches,
                                                   t.eta_l, avg_last=t.avg_last,
                                                   fault=self.fault)
            if fault_t is not None and policy is not None and retries < policy.max_retries:
                # roll back: the rounds past the checkpoint were run (their
                # releases happened) and run again, so they join the budget
                retries += 1
                if policy.backoff > 0.0:
                    time.sleep(policy.backoff * retries)
                back, seed, carry, hist = self._load(checkpoint_dir, retries=2,
                                                     backoff=policy.backoff)
                self._rounds_retried += fault_t + 1 - back
                bounds, idx = self._chunk_bounds(back, checkpoint_every), 0
                inject_pending = self._inject_divergence is not None
                continue
            hist = tuple(torch.cat([h, n]) for h, n in zip(hist, _srv.stack_outs(
                outs, self.device)))
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
                    batched_data: bool = False) -> RunResult:
        """A sweep over ``seeds``: every ``RunResult`` field gains a leading
        (S,) axis, and slice s equals ``run(seeds[s])`` bit for bit.

        The seeds run one after another through the round loop, as the JAX
        package's streamed sweep does.  ``batched_w0`` / ``batched_data``:
        the initial model (a (S, d) stack of flat vectors) / every leaf of the
        client data carries a leading seed axis, and seed s runs on its slice.
        """
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

        return RunResult(**{f.name: tree_stack([getattr(r, f.name) for r in results])
                            for f in dataclasses.fields(RunResult) if f.name != "fault_round"})

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
        q = 1.0 if self.cohort is None else self.cohort.sampling_rate(self.num_clients)
        dropout = self.fault.dropout if self.fault is not None and self.fault.injects else 0.0
        q = accounting.realized_participation(q, dropout)
        return self.algorithm.budget(delta, rounds=self.train.rounds + self._rounds_retried,
                                     dim=self.dim, sampling_q=q)
