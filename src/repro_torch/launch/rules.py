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
from repro_torch.models import transformer

__all__ = ["GIANT_PARAM_THRESHOLD", "count_params", "is_giant"]

GIANT_PARAM_THRESHOLD = 20e9


def count_params(model) -> int:
    """Exact parameter count of a ``DecoderLM`` or of the ``ModelConfig`` it
    would be built from, as the JAX package's ``count_params`` counts it:
    the embedding, the final norm, every block and an untied head.  A config
    counts from the defs alone (no tensor is made, so a 104 B configuration
    counts in milliseconds); a model counts its parameters."""
    if not isinstance(model, ModelConfig):
        return sum(p.numel() for p in model.parameters())
    cfg = model
    if cfg.arch_type not in transformer.ARCHS:
        raise NotImplementedError(
            f"{cfg.name}: the port's DecoderLM runs {' and '.join(transformer.ARCHS)} stacks; "
            f"{cfg.arch_type} stacks are still to port (ROADMAP queue 1, item 17)")
    block = sum(math.prod(p.shape) for p in transformer.block_defs(cfg).values())
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
    return cfg.vocab_size * cfg.d_model + cfg.d_model + cfg.num_layers * block + head


def is_giant(cfg: ModelConfig, num_params: int) -> bool:
    """Whether a model is large enough that one client spans the whole device
    grid in the JAX package's sharding rules (>= 20 B parameters)."""
    return num_params >= GIANT_PARAM_THRESHOLD
