"""Launch path of the port: serving (``serve.ServeEngine``), federated
training of a decoder LM or an enc-dec (``train.FederatedTrainer``), the
datacenter layout (``rules.make_rules``, ``safe_pspec``, ``tree_shardings``;
``mesh.make_production_mesh``, ``make_test_mesh``; the input specs of
``specs``), the dry-run (``python -m repro_torch.launch.dryrun``, with
``op_cost`` counting a step on the meta device and ``roofline`` on the H100's
constants), parameter counting (``rules.count_params``), the client mesh of
a sharded cohort (``mesh.make_client_mesh``, ``auto_shard_count``,
``client_shard_spec``) and the streaming engine's memory sizing
(``mesh.auto_chunk_clients``)."""
from repro_torch.launch.mesh import (
    MIN_CLIENTS_PER_SHARD,
    auto_chunk_clients,
    auto_shard_count,
    client_shard_spec,
    device_memory_budget,
    make_client_mesh,
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.launch.rules import (
    GIANT_PARAM_THRESHOLD,
    count_params,
    is_giant,
    make_rules,
    safe_pspec,
    tree_shardings,
)
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.train import FederatedTrainer, TrainNoise

__all__ = ["ServeEngine", "FederatedTrainer", "TrainNoise", "count_params", "is_giant",
           "GIANT_PARAM_THRESHOLD", "auto_chunk_clients", "device_memory_budget",
           "make_client_mesh", "auto_shard_count", "client_shard_spec", "MIN_CLIENTS_PER_SHARD",
           "make_rules", "safe_pspec", "tree_shardings", "make_production_mesh",
           "make_test_mesh"]
