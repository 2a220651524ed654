"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

``dp_aggregate`` (the round loop), ``flash_attention`` (the dense decoders'
prefill) and ``ssd_scan`` (the Mamba2 prefill): every Pallas kernel of the
JAX package has its counterpart here.  ``_build`` compiles each kernel's
``csrc/`` with nvcc at first use.
"""
