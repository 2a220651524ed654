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

DP-SCAFFOLD trains with control variates: ``FederatedSession(
make_algorithm("dp-scaffold", ...), ..., local=LocalSpec(control_variates=True))``.

``params`` may be a flat (d,) vector or a tree of tensors (dicts, lists);
the session flattens a tree once (``flatten_model``), wraps the loss and eval
closures, and unravels ``RunResult.final_w`` / ``last_w`` back to the
caller's structure.  ``params`` and ``client_batches`` may be numpy arrays or
tensors; the session moves them to ``device``, floating data as float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core.algorithm import ServerAlgorithm
from repro_torch.device import resolve_device
from repro_torch.fedsim import server as _srv
from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import cohort_updates, cohort_updates_scaffold
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.specs import CohortSpec, EngineSpec, LocalSpec, TrainSpec
from repro_torch.tree import tree_leaves, tree_map, tree_stack

__all__ = ["FederatedSession"]


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
            a seed axis for ``run_batched(batched_data=True)``).
          train: rounds, tau, eta_l, iterate averaging, eval cadence.
          local: how clients train (``LocalSpec``): None or the default is
            full-batch GD; ``control_variates=True`` SCAFFOLD's steps, which
            a control-variate algorithm (``dp-scaffold``) needs and only it
            takes.
          engine: how the round loop runs (``EngineSpec``: eager only).
          cohort: who participates each round (``CohortSpec``); None or
            ``CohortSpec()`` is full participation.
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
        self.device = resolve_device(device)
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

    def _check_local(self) -> None:
        """Refuse a LocalSpec the port has no trainer for, and a control-variate
        algorithm without the control-variate trainer, or the other way round."""
        local = self.local
        if local is not None and not local.is_default and not local.control_variates:
            raise NotImplementedError(
                f"{local!r} is not ported yet: the minibatch, proximal and momentum "
                "trainers come with ROADMAP.md queue 1, item 19; the port trains full-batch "
                "GD or LocalSpec(control_variates=True)")
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

    def _local_fn(self, w, batches, eta_l, *ctx):
        """The trainer: full-batch GD, or SCAFFOLD's steps on the context
        ``(c_i rows, c)`` that the round appends for a control-variate
        algorithm."""
        if ctx:
            return cohort_updates_scaffold(self.loss_fn, w, batches, self.train.tau, eta_l,
                                           *ctx)
        return cohort_updates(self.loss_fn, w, batches, self.train.tau, eta_l)

    def _restore(self, w):
        return w if self._unravel is None else self._unravel(w)

    def run(self, seed: int) -> RunResult:
        """Run all ``train.rounds`` rounds from round 0; round t draws its
        randomness from ``round_generator(seed, t)``."""
        if self._w0.dim() == 2:
            raise ValueError(
                f"params of shape {tuple(self._w0.shape)} is a stack of initial models; run it "
                "with run_batched(seeds, batched_w0=True), or pass a flat (d,) vector or a tree")
        return self._run(seed, self._w0, self.client_batches)

    def _run(self, seed: int, w0, client_batches) -> RunResult:
        t = self.train
        result = _srv.run_eager(self.algorithm, self._local_fn, w0, client_batches,
                                rounds=t.rounds, eta_l=t.eta_l, seed=seed,
                                eval_fn=self.eval_fn, avg_last=t.avg_last,
                                eval_every=t.eval_every, cohort=self.cohort)
        result.final_w = self._restore(result.final_w)
        result.last_w = self._restore(result.last_w)
        return result

    def run_batched(self, seeds, *, batched_w0: bool = False,
                    batched_data: bool = False) -> RunResult:
        """A sweep over ``seeds``: every ``RunResult`` field gains a leading
        (S,) axis, and slice s equals ``run(seeds[s])`` bit for bit.

        The seeds run one after another through the round loop, as the JAX
        package's streamed sweep does.  ``batched_w0`` / ``batched_data``:
        the initial model (a (S, d) stack of flat vectors) / every leaf of the
        client data carries a leading seed axis, and seed s runs on its slice.
        """
        seeds = [int(s) for s in seeds]
        if batched_w0 and self._unravel is not None:
            raise ValueError(
                "batched_w0 with a tree model is ambiguous (the seed axis would be raveled "
                "into the parameters); stack flat vectors via flatten_model and unravel per "
                "seed instead")
        if batched_w0 and (self._w0.dim() != 2 or self._w0.shape[0] != len(seeds)):
            raise ValueError(f"batched_w0 needs a ({len(seeds)}, d) stack of initial models, "
                             f"got shape {tuple(self._w0.shape)}")
        leaf = tree_leaves(self.client_batches)[0]
        if batched_data and leaf.shape[0] != len(seeds):
            raise ValueError(f"batched_data needs a leading axis of {len(seeds)} seeds on "
                             f"every leaf, got shape {tuple(leaf.shape)}")
        self._validate_cohort(leaf.shape[1 if batched_data else 0])
        results = [self._run(seed,
                             self._w0[i] if batched_w0 else self._w0,
                             tree_map(lambda x, i=i: x[i], self.client_batches) if batched_data
                             else self.client_batches)
                   for i, seed in enumerate(seeds)]

        return RunResult(**{f.name: tree_stack([getattr(r, f.name) for r in results])
                            for f in dataclasses.fields(RunResult)})

    def privacy_report(self, delta: float) -> accounting.PrivacyReport:
        """Privacy budget of this session's full run; raises for non-private
        algorithms.  The cohort's per-round sampling rate feeds the
        subsampled-GDP accounting of CDP releases (``accounting.cdp_budget``);
        LDP guarantees are per release and do not amplify."""
        q = 1.0 if self.cohort is None else self.cohort.sampling_rate(self.num_clients)
        return self.algorithm.budget(delta, rounds=self.train.rounds, dim=self.dim,
                                     sampling_q=q)
