"""Launch path of the port: serving (``serve.ServeEngine``), federated
training of a decoder LM (``train.FederatedTrainer``), parameter counting
(``rules.count_params``) and the streaming engine's memory sizing
(``mesh.auto_chunk_clients``).  The sharding rules, the client mesh, the
launch specs and the dry-run tools are still to port (ROADMAP queue 1,
items 16 and 18)."""
from repro_torch.launch.mesh import auto_chunk_clients, device_memory_budget
from repro_torch.launch.rules import GIANT_PARAM_THRESHOLD, count_params, is_giant
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.train import FederatedTrainer, TrainNoise

__all__ = ["ServeEngine", "FederatedTrainer", "TrainNoise", "count_params", "is_giant",
           "GIANT_PARAM_THRESHOLD", "auto_chunk_clients", "device_memory_budget"]
