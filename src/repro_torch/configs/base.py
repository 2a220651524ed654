"""Config system: architectures, input shapes, federated/DP round settings.

Every assigned architecture is a ``ModelConfig`` (see repro/configs/<id>.py,
each citing its source); the four canonical input shapes are ``ShapeConfig``s.
``FederatedConfig`` carries the DP-FedEXP round parameters into the datacenter
path (launch/train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // num_heads
    activation: str = "swiglu"           # swiglu | geglu | gelu
    sliding_window: int | None = None    # SWA width (h2o-danube3)
    qk_norm: bool = False                # chameleon-style qk layernorm
    attn_logit_softcap: float | None = None   # gemma-style softcap
    use_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True                # False -> sinusoidal abs positions (whisper)
    parallel_block: bool = False         # command-r parallel attn+FFN residual
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False      # llama4-style always-on shared expert
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    # --- hybrid (zamba2-style): one shared attention block applied every k ---
    hybrid_attn_every: int = 0
    # --- enc-dec (whisper): encoder layers with non-causal attention ---
    num_encoder_layers: int = 0
    # --- notes / provenance ---
    source: str = ""
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM, hybrid, or sliding-window attention."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """DP-FedEXP round parameters for the datacenter path.

    ``algorithm`` selects the server rule: cdp-fedexp (default: the paper's
    hyperparameter-free central setting), dp-fedavg-cdp, ldp-fedexp-gauss,
    dp-fedavg-ldp-gauss, fedexp, fedavg.
    """

    algorithm: str = "cdp-fedexp"
    clip_norm: float = 1.0
    noise_sigma: float = 1.0          # paper's sigma (CDP server std = sigma/sqrt(M))
    local_steps: int = 2              # tau (kept small for dry-run compile cost)
    local_lr: float = 0.01            # eta_l
    # cohort geometry (see DESIGN.md §4): which mesh axes enumerate clients.
    client_axes: tuple[str, ...] = ("data",)
    virtual_clients: int = 1          # sequential cohort members per client slot


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=4 experts etc.)."""
    head_dim = 64
    heads = max(2, d_model // 128)
    kv = max(1, min(cfg.num_kv_heads, heads // 2)) if cfg.num_kv_heads < cfg.num_heads else heads
    if cfg.num_heads > 0 and cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=2 * d_model,
        vocab_size=512,
    )
    if cfg.num_experts:
        changes.update(num_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=32)
    if cfg.hybrid_attn_every:
        changes.update(hybrid_attn_every=2)
    if cfg.num_encoder_layers:
        changes.update(num_encoder_layers=layers)
    if cfg.sliding_window:
        changes.update(sliding_window=64)
    return dataclasses.replace(cfg, **changes)
