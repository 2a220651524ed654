"""gemma-2b [dense] — Gemma Team, arXiv:2403.08295.

18L, d_model 2048, 8 heads with MQA (1 KV head), head_dim 256, GeGLU
d_ff 16384, vocab 256000, tied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295",
    notes="MQA on the 2b variant; head_dim 256 (8*256 != d_model, separate o-proj fan-in).",
)
