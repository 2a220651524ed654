"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

``dp_aggregate`` (the round loop) and ``flash_attention`` (the model zoo's
prefill) are ported; ``ssd_scan`` (Mamba2) is still to port (ROADMAP.md,
queue 2).  ``_build`` compiles each kernel's ``csrc/`` with nvcc at first use.
"""
