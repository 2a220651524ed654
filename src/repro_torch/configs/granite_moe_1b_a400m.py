"""granite-moe-1b-a400m [moe] — IBM, hf:ibm-granite/granite-3.0-1b-a400m-base.

24L, d_model 1024, 16 heads / 8 KV (GQA), per-expert d_ff 512, vocab 49155,
32 experts with top-8 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    activation="swiglu",
    num_experts=32,
    top_k=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="1B total / ~400M active; experts sharded over the model axis (all-to-all dispatch).",
)
