"""h2o-danube-3-4b [dense] — H2O.ai, arXiv:2401.16818 (danube series).

24L, d_model 3840, 32 heads / 8 KV (GQA), d_ff 10240, vocab 32000,
llama+mistral mix with sliding-window attention (window 4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32_000,
    activation="swiglu",
    sliding_window=4096,
    tie_embeddings=False,
    source="arXiv:2401.16818",
    notes="SWA makes this dense arch eligible for long_500k decode (window-bounded KV).",
)
