"""Feed-forward blocks: SwiGLU / GeGLU / plain GELU (counterpart of repro/models/mlp.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Param

__all__ = ["mlp_defs", "mlp_apply"]


def mlp_defs(cfg: ModelConfig, prefix: str = "mlp_", d_ff: int | None = None) -> dict[str, Param]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    defs = {
        prefix + "wi": Param((d, (2 if gated else 1) * f), ("embed", "ff"), fan_in=d),
        prefix + "wo": Param((f, d), ("ff", "embed"), fan_in=f),
    }
    if cfg.use_bias:
        defs[prefix + "wi_b"] = Param(((2 if gated else 1) * f,), ("ff",))
        defs[prefix + "wo_b"] = Param((d,), ("embed",))
    return defs


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig, prefix: str = "mlp_") -> torch.Tensor:
    """``params`` maps the names of ``mlp_defs`` to tensors.  GELU is the tanh
    approximation, which is ``jax.nn.gelu``'s default."""
    h = x @ params[prefix + "wi"]
    if prefix + "wi_b" in params:
        h = h + params[prefix + "wi_b"]
    if cfg.activation in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate) if cfg.activation == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ params[prefix + "wo"]
    if prefix + "wo_b" in params:
        y = y + params[prefix + "wo_b"]
    return y
