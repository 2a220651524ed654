"""command-r-plus-104b [dense] — Cohere, hf:CohereForAI/c4ai-command-r-v01.

64L, d_model 12288, 96 heads / 8 KV (GQA), d_ff 33792, vocab 256000,
no biases, parallel attention+FFN residual block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256_000,
    activation="swiglu",
    use_bias=False,
    parallel_block=True,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
    notes="104B params; client cohort must span the full device grid (DESIGN.md §4).",
)
