"""Launch path of the port: serving (``serve.ServeEngine``) and the
streaming engine's memory sizing (``mesh.auto_chunk_clients``).  Training,
the client mesh and the dry-run tools are still to port (ROADMAP queue 1,
items 16 and 18)."""
from repro_torch.launch.mesh import auto_chunk_clients, device_memory_budget
from repro_torch.launch.serve import ServeEngine

__all__ = ["ServeEngine", "auto_chunk_clients", "device_memory_budget"]
