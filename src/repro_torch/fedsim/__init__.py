"""Federated simulation of the port: ``FederatedSession`` over the eager round loop,
with the ``LocalSpec`` trainers, fault injection, the divergence watchdog and
checkpoints."""

from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import (
    build_cohort_local_fn,
    cohort_updates,
    cohort_updates_scaffold,
    cohort_updates_spec,
    gather_rows,
    gather_slots,
    local_update,
    local_update_scaffold,
    local_update_spec,
    mask_rows,
)
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.session import FederatedSession, RecoveryPolicy
from repro_torch.fedsim.specs import CohortSpec, EngineSpec, FaultSpec, LocalSpec, TrainSpec

__all__ = ["flatten_model", "local_update", "cohort_updates", "local_update_spec",
           "cohort_updates_spec", "build_cohort_local_fn", "local_update_scaffold",
           "cohort_updates_scaffold", "mask_rows", "gather_slots", "gather_rows", "RunResult",
           "FederatedSession", "RecoveryPolicy", "TrainSpec", "LocalSpec", "EngineSpec",
           "CohortSpec", "FaultSpec"]
