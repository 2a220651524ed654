"""The round loop (counterpart of repro/fedsim/server.py).

Ported so far: ``RunResult`` with ``avg_last`` iterate averaging, the
unsampled, unfaulted branch of ``_round_step`` and the eager round loop of
``_run_eager``, as a plain Python loop that threads the round index t into
every round (noise schedules read it).  Nothing in the loop waits for the
device: histories stay tensors until the run ends, and state such as an
adaptive clip threshold stays on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.algorithm import ServerAlgorithm, round_generator

__all__ = ["RunResult", "run_eager"]


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


def round_step(algorithm: ServerAlgorithm, local_fn: Callable, eval_fn, eval_every: int = 1):
    """One full-participation server round as ``step(w, state, gen, t, batches, eta_l)``."""

    def step(w, state, gen, t, client_batches, eta_l):
        deltas = local_fn(w, client_batches, eta_l)
        w_next, aux, state = algorithm.apply_round_stateful(gen, w, deltas, state, t=t)
        metric = _eval_metric(eval_fn, eval_every, w_next, t, w.device)
        return w_next, state, (aux.eta_g, metric, aux.eta_naive, aux.eta_target)

    return step


def run_eager(algorithm: ServerAlgorithm, local_fn: Callable, w0: torch.Tensor,
              client_batches, *, rounds: int, eta_l: float, seed: int, eval_fn,
              avg_last: int, eval_every: int = 1) -> RunResult:
    """``rounds`` rounds from ``w0``; round t draws from ``round_generator(seed, t)``."""
    step = round_step(algorithm, local_fn, eval_fn, eval_every)
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
