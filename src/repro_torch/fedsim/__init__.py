"""Federated simulation of the port: ``FederatedSession`` over the scan (CUDA
graphs, the default), the eager and the streamed round loops, the cohort
optionally split over the ranks of a client mesh (``ShardSpec``), with the ``LocalSpec``
trainers, sampled cohorts, fault injection, the divergence watchdog,
checkpoints, telemetry, and client data on the device or behind a host, disk
or generated source."""

from repro_torch.fedsim.data import (
    ArraySource,
    ClientDataSource,
    HostArraySource,
    NpzSource,
    SyntheticSource,
    as_data_source,
)
from repro_torch.fedsim.flat import flatten_model
from repro_torch.fedsim.local import (
    build_cohort_local_fn,
    chunk_cohort,
    cohort_updates,
    cohort_updates_scaffold,
    cohort_updates_spec,
    gather_rows,
    gather_slots,
    local_update,
    local_update_scaffold,
    local_update_spec,
    mask_rows,
    masked_cohort_updates,
    pad_cohort,
)
from repro_torch.fedsim.server import RunResult
from repro_torch.fedsim.session import FederatedSession, RecoveryPolicy
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

__all__ = ["flatten_model", "local_update", "cohort_updates", "local_update_spec",
           "cohort_updates_spec", "build_cohort_local_fn", "local_update_scaffold",
           "cohort_updates_scaffold", "mask_rows", "masked_cohort_updates", "gather_slots", "gather_rows", "RunResult",
           "FederatedSession", "RecoveryPolicy", "TrainSpec", "LocalSpec", "EngineSpec", "ShardSpec",
           "CohortSpec", "FaultSpec", "StreamSpec", "DataSpec", "TelemetrySpec", "pad_cohort", "chunk_cohort",
           "ClientDataSource", "ArraySource", "HostArraySource", "NpzSource", "SyntheticSource",
           "as_data_source"]
