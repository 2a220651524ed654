"""Launch path of the port: serving (``serve.ServeEngine``).  Training, the
mesh and the dry-run tools are still to port (ROADMAP queue 1, item 18)."""
from repro_torch.launch.serve import ServeEngine

__all__ = ["ServeEngine"]
