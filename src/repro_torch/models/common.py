"""Common building blocks of the model zoo (counterpart of repro/models/common.py)."""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "layer_norm", "rope", "sinusoidal_positions", "softcap", "dense_init",
           "Param", "init_params", "logical_specs"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (norm weights start at zero)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm in float32, scaled by ``1 + scale`` (norm weights start at
    zero, as for ``rms_norm``) plus ``bias``, cast back to ``x``'s dtype.
    ``1 + scale`` is taken in the scale's dtype, as the JAX package takes it."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * (1.0 + scale) + bias).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap * tanh(x / cap)``; the identity for ``cap=None``."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the two HALVES of the head (not interleaved pairs),
    angles in float32.  x: (..., S, H, Dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    # a Python-scalar base: a theta tensor made on the card would be a blocking copy per call
    freqs = 1.0 / torch.pow(theta, exponent)
    angles = positions[..., None].float() * freqs                 # (..., S, half)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(length, dim) sine/cosine absolute position table (non-RoPE archs)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: dim // 2])
    return pe.to(dtype)


class Param:
    """(shape, logical axes, fan_in) of one parameter, as in the JAX package.
    The logical axes are what the launch layer's rules map onto a mesh
    (``launch/rules.py``); no parameter of the port is split by them."""

    def __init__(self, shape, logical, fan_in=None):
        self.shape = tuple(shape)
        self.logical = tuple(logical)
        self.fan_in = fan_in if fan_in is not None else (shape[0] if len(shape) > 1 else 1)
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {shape} and logical axes {logical} differ in rank")


def dense_init(generator: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), drawn in float32 on the generator's device.  A
    stack of experts (three dimensions) is drawn an expert at a time into a
    tensor of ``dtype``, so that no float32 copy of the whole stack exists
    (llama4's (128, 5120, 16384) would be 43 GB)."""
    if len(shape) == 3:
        out = torch.empty(shape, dtype=dtype, device=generator.device)
        for i in range(shape[0]):
            out[i] = dense_init(generator, shape[1:], fan_in, dtype)
        return out
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (w / math.sqrt(float(fan_in))).to(dtype)


def init_params(generator: torch.Generator, defs: dict[str, Param], dtype) -> dict:
    """Initial values of ``defs``: vectors, biases and norms zero, matrices
    ``dense_init``.  The draws follow sorted names, as the JAX package's keys
    do, but from a ``torch.Generator``: the distribution matches, not the values."""
    out = {}
    for name, p in sorted(defs.items()):
        if len(p.shape) == 1 or name.endswith("_b") or "norm" in name:
            out[name] = torch.zeros(p.shape, dtype=dtype, device=generator.device)
        else:
            out[name] = dense_init(generator, p.shape, p.fan_in, dtype)
    return out


def logical_specs(defs: dict[str, Param]) -> dict:
    """{name: logical axes} of ``defs`` (the JAX package's ``logical_specs``)."""
    return {name: p.logical for name, p in defs.items()}
