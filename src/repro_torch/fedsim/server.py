"""The round loop (counterpart of repro/fedsim/server.py).

Ported so far: ``RunResult`` with ``avg_last`` iterate averaging, the
unfaulted branches of ``_round_step`` and the eager round loop of
``_run_eager``, as a plain Python loop that threads the round index t into
every round (noise schedules read it).  A full-participation round is one
dense ``apply_round_stateful``.  A sampled round (``CohortSpec``) is the
masked-moment protocol: the cohort mask, drawn first from the round's
generator on the host, then the algorithm's noise for all M clients; local
training on every client, or with ``gather`` on the sampled ones only;
``mask_rows``; ``local_moments``; the count resolved; ``apply_from_moments``.
An algorithm that declares ``uses_local_context`` (DP-SCAFFOLD) has
``local_context(state, start, m)`` appended to the trainer call in both
rounds (``local_caller``): each block of clients trains on its own rows of
the server's carry; its ``local_moments`` also gets the block's host mask
(``host_mask=``), by which it expands a with-replacement multiplicity
without reading the device.  Nothing in the loop waits for the device: host values
reach it by pinned non-blocking copies, histories stay tensors until the
run ends, and state such as an adaptive clip threshold or DP-SCAFFOLD's
variate table stays on the device.  Faults, streaming
and sharding come in later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.algorithm import (
    ServerAlgorithm,
    clamp_moment_counts,
    host_to_device,
    round_generator,
    set_moment_count,
)
from repro_torch.fedsim.local import gather_rows, gather_slots, mask_rows
from repro_torch.fedsim.specs import CohortSpec
from repro_torch.tree import tree_leaves

__all__ = ["RunResult", "run_eager", "round_step", "sampled_round", "local_caller"]


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

    def eval_rounds(self) -> list[tuple[int, float]]:
        """(round, metric) pairs for the rounds the eval cadence evaluated."""
        return [(t, v) for t, v in enumerate(self.metric_history.tolist())
                if math.isfinite(v)]


def _eval_metric(eval_fn, eval_every: int, w_next, t: int, device) -> torch.Tensor:
    """Per-round metric honoring the eval cadence (NaN off cadence)."""
    if eval_fn is None or (t + 1) % eval_every:
        return torch.full((), float("nan"), device=device)
    return torch.as_tensor(eval_fn(w_next), dtype=torch.float32)


def local_caller(local_fn: Callable, algorithm: ServerAlgorithm) -> Callable:
    """The trainer as ``call(w, batches, eta_l, start, state)``.

    It is ``local_fn(w, batches, eta_l)``; when the algorithm declares
    ``uses_local_context``, ``algorithm.local_context(state, start, m)`` of
    the block's m clients at ``start`` (0, or a gathered block's host slot
    tensor) is appended as a fourth argument."""
    if not getattr(algorithm, "uses_local_context", False):
        return lambda w, batches, eta_l, start, state: local_fn(w, batches, eta_l)

    def call(w, batches, eta_l, start, state):
        m = tree_leaves(batches)[0].shape[0]
        return local_fn(w, batches, eta_l, algorithm.local_context(state, start, m))

    return call


def _resolve_sampled_count(moments, cohort: CohortSpec, algorithm):
    """The client count of a sampled round's moments: a fixed cohort's size
    (static), else the count clamped to >= 1, so an empty Bernoulli round is
    a zero update and not NaN.  A weighted count is a weight sum: only the
    empty round is guarded (floor 1e-12)."""
    if getattr(algorithm, "supports_static_count", True):
        if cohort.size is not None:
            return set_moment_count(moments, cohort.size)
        return clamp_moment_counts(moments)
    return clamp_moment_counts(moments, floor=1e-12)


def sampled_round(algorithm: ServerAlgorithm, local_fn: Callable, w, state, noise, mask,
                  cohort: CohortSpec, t, client_batches, eta_l):
    """One masked-moment round for the host participation ``mask`` (M,) and
    the round's ``noise`` (drawn for all M clients): ``-> (w_next, aux, state)``."""
    m = mask.shape[0]
    if cohort.gather:
        slots, slot_mask, _ = gather_slots(mask, cohort.resolved_cap(m))
        client_batches = gather_rows(client_batches, host_to_device(slots, w.device))
        mask, start = slot_mask, slots
    else:
        start = 0
    host_mask, mask = mask, host_to_device(mask, w.device)
    deltas = mask_rows(local_caller(local_fn, algorithm)(w, client_batches, eta_l, start, state),
                       mask)
    extra = {"host_mask": host_mask} if getattr(algorithm, "uses_local_context", False) else {}
    moments = algorithm.local_moments(noise, w, deltas, mask, start, state, t,
                                      binary_mask=not cohort.replace, **extra)
    moments = _resolve_sampled_count(moments, cohort, algorithm)
    return algorithm.apply_from_moments(noise, w, moments, state, t)


def round_step(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn, eval_every: int = 1,
               cohort: CohortSpec | None = None):
    """One server round as ``step(w, state, gen, t, batches, eta_l)``: the
    dense round, or with a sampling ``cohort`` the masked-moment round."""
    sampled = cohort is not None and cohort.is_sampled
    local = local_caller(local_fn, algorithm)

    def step(w, state, gen, t, client_batches, eta_l):
        if not sampled:
            deltas = local(w, client_batches, eta_l, 0, state)
            w_next, aux, state = algorithm.apply_round_stateful(gen, w, deltas, state, t=t)
        else:
            m = tree_leaves(client_batches)[0].shape[0]
            mask = cohort.round_mask(gen, m)
            noise = algorithm.draw_noise(gen, m, w.shape[-1], w.device, t)
            w_next, aux, state = sampled_round(algorithm, local_fn, w, state, noise, mask,
                                               cohort, t, client_batches, eta_l)
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        return w_next, state, (aux.eta_g, metric, aux.eta_naive, aux.eta_target)

    return step


def run_eager(algorithm: ServerAlgorithm, local_fn: Callable, w0: torch.Tensor,
              client_batches, *, rounds: int, eta_l: float, seed: int, eval_fn,
              avg_last: int, eval_every: int = 1, cohort: CohortSpec | None = None
              ) -> RunResult:
    """``rounds`` rounds from ``w0``; round t draws from ``round_generator(seed, t)``."""
    step = round_step(algorithm, local_fn, eval_fn, eval_every, cohort)
    w = w0
    state = algorithm.init_state(w0)
    tail: list[torch.Tensor] = []
    outs = []
    for t in range(rounds):
        w, state, out = step(w, state, round_generator(seed, t), t, client_batches, eta_l)
        outs.append(out)
        tail.append(w)
        if len(tail) > avg_last:
            tail.pop(0)
    etas, metrics, naives, targets = (torch.stack([o[i].to(w.device) for o in outs])
                                      for i in range(4))
    return RunResult(final_w=torch.stack(tail).mean(dim=0), last_w=w, eta_history=etas,
                     metric_history=metrics, eta_naive_history=naives,
                     eta_target_history=targets)
