"""DP-SCAFFOLD's standalone entry point (counterpart of repro/fedsim/scaffold.py).

SCAFFOLD removes client drift with control variates: client i steps with
``g - c_i + c`` and refreshes its variate by option II,
``c_i+ = c_i - c + (w - y_i) / (tau * eta_l)``.  Under client-level DP the
client releases two vectors a round, the model update and the variate
update, each clipped and noised at std sigma sqrt(2), so that the round's
budget is one release's at std sigma (the "noise doubling" the paper's §5
points at).

``run_dp_scaffold`` is deprecated: it runs ``make_algorithm("dp-scaffold",
...)`` under ``FederatedSession`` with ``LocalSpec(control_variates=True)``
on full participation, which is where the algorithm lives.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

from repro_torch.core.fedexp import make_algorithm
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.session import FederatedSession
from repro_torch.fedsim.specs import LocalSpec, TrainSpec

__all__ = ["DPScaffoldConfig", "run_dp_scaffold"]

# the deprecation warning fires on the first call in a process, not on every
# call of a sweep
_WARNED = False


@dataclasses.dataclass(frozen=True)
class DPScaffoldConfig:
    """DP-SCAFFOLD knobs: clip, noise scale, central vs local noising, cohort size."""

    clip_norm: float
    sigma: float                 # baseline noise scale (as for DP-FedAvg)
    central: bool                # True: CDP (noise std sigma*sqrt(2)/sqrt(M) on means)
    num_clients: int


def run_dp_scaffold(cfg: DPScaffoldConfig, loss_fn: Callable, w0, client_batches, *,
                    rounds: int, tau: int, eta_l: float, seed: int,
                    eval_fn: Callable | None = None, avg_last: int = 2,
                    device="cuda") -> RunResult:
    """Run T rounds of DP-SCAFFOLD (two clipped and noised releases a round).

    A flat (d,) ``w0``, per-client batches with the client axis leading;
    round t draws from ``round_generator(seed, t)``.  Returns a ``RunResult``
    whose eta_history is all ones.  ``device`` as the session's.

    .. deprecated::
        Use ``make_algorithm("dp-scaffold", ...)`` under ``FederatedSession``
        with ``LocalSpec(control_variates=True)``, which this call runs.
    """
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(
            "run_dp_scaffold is deprecated: it is a standalone round loop outside the "
            "session (no sampled cohorts). Build the algorithm via "
            "make_algorithm('dp-scaffold', ...) and run it under FederatedSession with "
            "LocalSpec(control_variates=True).", DeprecationWarning, stacklevel=2)
    algorithm = make_algorithm("dp-scaffold", clip_norm=cfg.clip_norm, sigma=cfg.sigma,
                               central=cfg.central, num_clients=cfg.num_clients, tau=tau,
                               eta_l=eta_l)
    return FederatedSession(algorithm, loss_fn, w0, client_batches,
                            train=TrainSpec(rounds=rounds, tau=tau, eta_l=eta_l,
                                            avg_last=avg_last),
                            local=LocalSpec(control_variates=True), eval_fn=eval_fn,
                            device=device).run(seed)
