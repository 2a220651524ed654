"""Mamba2 chunked SSD scan: the CUDA kernel (``csrc/``), its wrapper and ctypes
binding (``ops``) and its plain PyTorch version, the step recurrence (``ref``)."""
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["ops", "ref", "ssd_scan"]
