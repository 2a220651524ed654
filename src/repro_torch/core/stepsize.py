"""Adaptive global step-size rules (counterpart of repro/core/stepsize.py).

All rules consume aggregate statistics of the round (means over the client
axis), as 0-dim float32 tensors or Python numbers, and return a 0-dim float32
tensor on the statistics' device.

Rules
-----
- ``fedexp``          Eq. (2)  — non-private FedEXP (Jhunjhunwala'23 / Li'24 form).
- ``naive_noisy``     Eq. (3)  — the broken naive extension (for Fig. 2 only).
- ``target``          Eq. (5)  — oracle eta_target (needs true Delta_i; diagnostics).
- ``ldp_gaussian``    Eq. (6)  — bias-corrected numerator: mean ||c_i||^2 - d sigma^2.
- ``ldp_gaussian_mixed``       — Eq. (6) under heterogeneous per-client sigma.
- ``ldp_privunit``    Eq. (7)  — mean of Algorithm-4 estimates s_hat_i.
- ``cdp``             Eq. (8)  — true numerator + scalar Gaussian noise xi.
- ``fedavg``                   — constant 1 (DP-FedAvg).
"""
from __future__ import annotations

import torch

__all__ = [
    "fedavg",
    "fedexp",
    "naive_noisy",
    "target",
    "ldp_gaussian",
    "ldp_gaussian_mixed",
    "ldp_privunit",
    "cdp",
]

_EPS = 1e-12


def _f32(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32)


def _ratio(numerator, denom_sq):
    return _f32(numerator) / torch.clamp(_f32(denom_sq), min=_EPS)


def fedavg(*_args, **_kwargs):
    """DP-FedAvg global step size: eta_g = 1."""
    return torch.tensor(1.0, dtype=torch.float32)


def fedexp(mean_sq_norm, agg_sq_norm):
    """Eq. (2): eta = max{1, (1/M sum ||Delta_i||^2) / ||mean Delta||^2}."""
    return torch.clamp(_ratio(mean_sq_norm, agg_sq_norm), min=1.0)


def naive_noisy(mean_sq_noisy_norm, agg_sq_norm):
    """Eq. (3): the naive noisy rule — biased upward by d*sigma^2 (Fig. 2)."""
    return _ratio(mean_sq_noisy_norm, agg_sq_norm)


def target(mean_sq_true_norm, agg_sq_noisy_norm):
    """Eq. (5): eta_target — requires the true per-client norms (oracle)."""
    return _ratio(mean_sq_true_norm, agg_sq_noisy_norm)


def ldp_gaussian(mean_sq_noisy_norm, agg_sq_norm, dim, sigma):
    """Eq. (6): ``mean ||c_i||^2 - d sigma^2`` over ``||cbar||^2``, floored at 1."""
    corrected = _f32(mean_sq_noisy_norm) - dim * sigma**2
    return torch.clamp(_ratio(corrected, agg_sq_norm), min=1.0)


def ldp_gaussian_mixed(mean_sq_noisy_norm, agg_sq_norm, dim, mean_sigma_sq):
    """Eq. (6) with the bias correction ``d * mean(sigma_i^2)``."""
    corrected = _f32(mean_sq_noisy_norm) - dim * mean_sigma_sq
    return torch.clamp(_ratio(corrected, agg_sq_norm), min=1.0)


def ldp_privunit(mean_s_hat, agg_sq_norm):
    """Eq. (7): LDP-FedEXP with PrivUnit; numerator = mean of Alg.-4 estimates."""
    return torch.clamp(_ratio(mean_s_hat, agg_sq_norm), min=1.0)


def cdp(mean_sq_true_norm, xi, agg_sq_norm):
    """Eq. (8): CDP-FedEXP — true numerator privatized by scalar noise xi."""
    return torch.clamp(_ratio(_f32(mean_sq_true_norm) + xi, agg_sq_norm), min=1.0)
