"""whisper-large-v3 [audio] — OpenAI, arXiv:2212.04356.

Enc-dec: 32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA),
d_ff 5120, GELU, vocab 51866, sinusoidal positions. The mel-spectrogram +
conv feature extractor frontend is STUBBED: input_specs() provides
precomputed frame embeddings (B, T, d_model) directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    activation="gelu",
    use_bias=True,
    use_rope=False,
    tie_embeddings=True,
    source="arXiv:2212.04356",
    notes="decode_32k exceeds Whisper's trained 448 positions; shape/lowering exercise (DESIGN.md §6).",
)
