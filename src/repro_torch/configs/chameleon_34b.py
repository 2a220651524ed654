"""chameleon-34b [vlm] — Meta, arXiv:2405.09818.

48L, d_model 8192, 64 heads / 8 KV (GQA), d_ff 22016, vocab 65536 including
VQ image codes (early fusion), qk-layernorm for stability. The VQ-VAE image
tokenizer is the stubbed frontend: input_specs() provides mixed text/image
token ids directly (discrete early fusion IS token-level).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    activation="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    source="arXiv:2405.09818",
)
