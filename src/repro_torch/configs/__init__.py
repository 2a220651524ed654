"""Architecture registry: the 10 assigned archs + the paper's own models.

A copy of the JAX package's ``configs`` (pure dataclasses, no JAX), kept
here so that the port imports nothing of that package; the tests hold the
two registries equal field by field.
"""

from repro_torch.configs import (
    chameleon_34b,
    command_r_plus_104b,
    gemma_2b,
    granite_8b,
    granite_moe_1b_a400m,
    h2o_danube_3_4b,
    llama4_maverick_400b_a17b,
    mamba2_2_7b,
    whisper_large_v3,
    zamba2_2_7b,
)
from repro_torch.configs.base import SHAPES, FederatedConfig, ModelConfig, ShapeConfig, reduced

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        gemma_2b, h2o_danube_3_4b, command_r_plus_104b, granite_moe_1b_a400m,
        zamba2_2_7b, llama4_maverick_400b_a17b, chameleon_34b, mamba2_2_7b,
        granite_8b, whisper_large_v3,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "get_config", "reduced",
           "ModelConfig", "ShapeConfig", "FederatedConfig"]
