"""Parameter counting and the giant-model threshold (counterpart of the
counting half of repro/launch/rules.py).

``count_params`` reads the parameter shapes from the model's defs, so a
configuration of any size counts without allocating a tensor.  The sharding
rules of the same module (``make_rules``, ``safe_pspec``, ``tree_shardings``)
come with client sharding (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

__all__ = ["GIANT_PARAM_THRESHOLD", "count_params", "is_giant"]

GIANT_PARAM_THRESHOLD = 20e9


def count_params(model) -> int:
    """Exact parameter count of a ``DecoderLM`` or ``EncDecLM``, or of the
    ``ModelConfig`` it would be built from, as the JAX package's
    ``count_params`` counts it: the embedding, the final norm, every block (an
    MoE block's experts E times), a hybrid's shared block once and an untied
    head; an enc-dec stack's embedding, encoder and decoder blocks and its four
    norms.  A config counts from the defs alone (no tensor is made, so a 104 B
    configuration counts in milliseconds); a model counts its parameters."""
    if not isinstance(model, ModelConfig):
        return sum(p.numel() for p in model.parameters())
    cfg = model

    def size(defs):
        return sum(math.prod(p.shape) for p in defs.values())

    if cfg.arch_type == "audio":
        return (cfg.vocab_size * cfg.d_model + len(encdec.NORMS) * cfg.d_model
                + cfg.num_encoder_layers * size(encdec.enc_block_defs(cfg))
                + cfg.num_layers * size(encdec.dec_block_defs(cfg)))

    shared = size(transformer.shared_attn_defs(cfg)) if cfg.arch_type == "hybrid" else 0
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
    return (cfg.vocab_size * cfg.d_model + cfg.d_model
            + cfg.num_layers * size(transformer.block_defs(cfg)) + shared + head)


def is_giant(cfg: ModelConfig, num_params: int) -> bool:
    """Whether a model is large enough that one client spans the whole device
    grid in the JAX package's sharding rules (>= 20 B parameters)."""
    return num_params >= GIANT_PARAM_THRESHOLD
