"""mamba2-2.7b [ssm] — Dao & Gu, arXiv:2405.21060 (SSD / state-space duality).

64 Mamba2 layers, d_model 2560 (attention-free), ssm_state 128,
head_dim 64 (d_inner 5120 -> 80 SSD heads), vocab 50280.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=None,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
    notes="attention-free; DP-FedEXP applies unchanged (update-space technique).",
)
