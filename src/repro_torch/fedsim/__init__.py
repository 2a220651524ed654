"""Federated simulation of the port: ``FederatedSession`` over the eager round loop."""

from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import (
    cohort_updates,
    gather_rows,
    gather_slots,
    local_update,
    mask_rows,
)
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.session import FederatedSession
from repro_torch.fedsim.specs import CohortSpec, EngineSpec, TrainSpec

__all__ = ["flatten_model", "local_update", "cohort_updates", "mask_rows", "gather_slots",
           "gather_rows", "RunResult", "FederatedSession", "TrainSpec", "EngineSpec",
           "CohortSpec"]
