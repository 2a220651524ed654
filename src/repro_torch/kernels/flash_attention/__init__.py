"""Flash (online-softmax) attention: the CUDA kernel (``csrc/``), its wrapper and
ctypes binding (``ops``) and its plain PyTorch version (``ref``)."""
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["ops", "ref", "flash_attention"]
