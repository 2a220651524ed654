"""Federated simulation of the port: ``FederatedSession`` over the eager round loop,
with fault injection, the divergence watchdog and checkpoints."""

from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import (
    cohort_updates,
    cohort_updates_scaffold,
    gather_rows,
    gather_slots,
    local_update,
    local_update_scaffold,
    mask_rows,
)
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.session import FederatedSession, RecoveryPolicy
from repro_torch.fedsim.specs import CohortSpec, EngineSpec, FaultSpec, LocalSpec, TrainSpec

__all__ = ["flatten_model", "local_update", "cohort_updates", "local_update_scaffold",
           "cohort_updates_scaffold", "mask_rows", "gather_slots", "gather_rows", "RunResult",
           "FederatedSession", "RecoveryPolicy", "TrainSpec", "LocalSpec", "EngineSpec",
           "CohortSpec", "FaultSpec"]
