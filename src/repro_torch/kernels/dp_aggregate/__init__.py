"""Fused clip + noise + reduce over the (M, d) client-update matrix: CUDA kernels
(``csrc/``), their wrappers and ctypes binding (``ops``) and plain
PyTorch versions (``ref``)."""
from repro_torch.kernels.dp_aggregate import ops, ref
from repro_torch.kernels.dp_aggregate.ops import dp_aggregate, dp_aggregate_sums, generate_ldp_noise

__all__ = ["ops", "ref", "dp_aggregate", "dp_aggregate_sums", "generate_ldp_noise"]
