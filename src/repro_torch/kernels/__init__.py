"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Only ``dp_aggregate`` is ported so far; ``flash_attention`` and ``ssd_scan``
(model zoo) are still to port (ROADMAP.md, queue 2).
"""
