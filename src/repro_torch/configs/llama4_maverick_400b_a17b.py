"""llama4-maverick-400b-a17b [moe] — Meta, hf:meta-llama/Llama-4-Scout-17B-16E family.

48L, d_model 5120, 40 heads / 8 KV (GQA), per-expert d_ff 8192, vocab 202048,
128 experts with top-1 routing + one always-on shared expert; early fusion
(text+image tokens in one vocab — frontend stubbed as for chameleon).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    activation="swiglu",
    num_experts=128,
    top_k=1,
    moe_shared_expert=True,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="~400B total / 17B active; giant arch -> cohort spans full grid (DESIGN.md §4).",
)
