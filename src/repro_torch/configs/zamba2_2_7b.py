"""zamba2-2.7b [hybrid] — Zyphra, arXiv:2411.15242.

54 Mamba2 blocks, d_model 2560, ssm_state 64, plus ONE weight-shared
attention(+MLP) block applied every 6 Mamba2 blocks (32 heads, MHA,
d_ff 10240). vocab 32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    activation="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
    notes="shared attn block = tied weights; its grads sum over the 9 application sites.",
)
