"""Launch path of the port: serving (``serve.ServeEngine``), federated
training of a decoder LM or an enc-dec (``train.FederatedTrainer``), parameter counting
(``rules.count_params``), the client mesh of a sharded cohort
(``mesh.make_client_mesh``, ``auto_shard_count``, ``client_shard_spec``) and
the streaming engine's memory sizing (``mesh.auto_chunk_clients``).  The
launch specs, the parameter sharding rules and the dry-run tools are still
to port (ROADMAP queue 1)."""
from repro_torch.launch.mesh import (
    MIN_CLIENTS_PER_SHARD,
    auto_chunk_clients,
    auto_shard_count,
    client_shard_spec,
    device_memory_budget,
    make_client_mesh,
)
from repro_torch.launch.rules import GIANT_PARAM_THRESHOLD, count_params, is_giant
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.train import FederatedTrainer, TrainNoise

__all__ = ["ServeEngine", "FederatedTrainer", "TrainNoise", "count_params", "is_giant",
           "GIANT_PARAM_THRESHOLD", "auto_chunk_clients", "device_memory_budget",
           "make_client_mesh", "auto_shard_count", "client_shard_spec", "MIN_CLIENTS_PER_SHARD"]
