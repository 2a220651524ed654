"""FederatedSession: the port's simulation entry point (counterpart of
repro/fedsim/session.py).

    session = FederatedSession(
        algorithm, loss_fn, params, client_batches,
        train=TrainSpec(rounds=50, tau=20, eta_l=0.1),
        cohort=CohortSpec(q=0.1, gather=True),      # optional: sampled rounds
        eval_fn=eval_fn, device="cuda")
    result = session.run(seed=0)
    report = session.privacy_report(delta=1e-5)

``params`` may be a flat (d,) vector or a tree of tensors (dicts, lists);
the session flattens a tree once (``flatten_model``), wraps the loss and eval
closures, and unravels ``RunResult.final_w`` / ``last_w`` back to the
caller's structure.  ``params`` and ``client_batches`` may be numpy arrays or
tensors; the session moves them to ``device``, floating data as float32.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core.algorithm import ServerAlgorithm
from repro_torch.device import resolve_device
from repro_torch.fedsim import server as _srv
from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import cohort_updates
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.specs import CohortSpec, EngineSpec, TrainSpec
from repro_torch.tree import tree_leaves, tree_map

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
                 client_batches, *, train: TrainSpec, engine: EngineSpec = EngineSpec(),
                 cohort: CohortSpec | None = None, eval_fn: Callable | None = None,
                 device="cuda"):
        """Bind (algorithm, loss, model, client data) to the specs.

        Args:
          algorithm: a ``ServerAlgorithm`` (``make_algorithm(...)`` or a
            ``compose_algorithm(...)`` composition).
          loss_fn: per-client loss ``loss_fn(params, client_batch) -> scalar``
            on the caller's parameter structure.
          params: initial model — a flat (d,) vector or a tree of tensors.
          client_batches: tree of per-client data, client axis leading.
          train: rounds, tau, eta_l, iterate averaging, eval cadence.
          engine: how the round loop runs (``EngineSpec``: eager only).
          cohort: who participates each round (``CohortSpec``); None or
            ``CohortSpec()`` is full participation.
          eval_fn: optional metric closure ``eval_fn(params) -> scalar``.
          device: where the run executes; "cuda" (the default) raises when no
            card is present — the CPU runs only when asked for.
        """
        self.algorithm = algorithm
        self.train = train
        self.engine = engine
        self.cohort = cohort
        self.device = resolve_device(device)
        self.client_batches = tree_map(lambda x: _to_device(x, self.device), client_batches)
        self.num_clients = tree_leaves(self.client_batches)[0].shape[0]
        self._validate_cohort(self.num_clients)
        params = tree_map(lambda x: _to_device(x, self.device), params)
        if isinstance(params, torch.Tensor):
            self._w0, self._unravel = params.reshape(-1), None
            self.loss_fn, self.eval_fn = loss_fn, eval_fn
        else:
            self._w0, self._unravel = flatten_model(params)
            unravel = self._unravel
            self.loss_fn = lambda wf, batch: loss_fn(unravel(wf), batch)
            self.eval_fn = None if eval_fn is None else (lambda wf: eval_fn(unravel(wf)))

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

    @property
    def dim(self) -> int:
        """Flat model dimension d (after any tree flatten)."""
        return self._w0.shape[-1]

    def _local_fn(self, w, batches, eta_l):
        return cohort_updates(self.loss_fn, w, batches, self.train.tau, eta_l)

    def _restore(self, w):
        return w if self._unravel is None else self._unravel(w)

    def run(self, seed: int) -> RunResult:
        """Run all ``train.rounds`` rounds from round 0; round t draws its
        randomness from ``round_generator(seed, t)``."""
        t = self.train
        result = _srv.run_eager(self.algorithm, self._local_fn, self._w0, self.client_batches,
                                rounds=t.rounds, eta_l=t.eta_l, seed=seed,
                                eval_fn=self.eval_fn, avg_last=t.avg_last,
                                eval_every=t.eval_every, cohort=self.cohort)
        result.final_w = self._restore(result.final_w)
        result.last_w = self._restore(result.last_w)
        return result

    def privacy_report(self, delta: float) -> accounting.PrivacyReport:
        """Privacy budget of this session's full run; raises for non-private
        algorithms.  The cohort's per-round sampling rate feeds the
        subsampled-GDP accounting of CDP releases (``accounting.cdp_budget``);
        LDP guarantees are per release and do not amplify."""
        q = 1.0 if self.cohort is None else self.cohort.sampling_rate(self.num_clients)
        return self.algorithm.budget(delta, rounds=self.train.rounds, dim=self.dim,
                                     sampling_q=q)
