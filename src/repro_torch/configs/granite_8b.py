"""granite-8b [dense] — IBM Granite Code, arXiv:2405.04324.

36L, d_model 4096, 32 heads / 8 KV (GQA), d_ff 14336, vocab 49152,
llama-style SwiGLU decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49_152,
    activation="swiglu",
    tie_embeddings=False,
    source="arXiv:2405.04324",
)
