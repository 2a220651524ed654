"""Adaptive clipping (Andrew et al., NeurIPS 2021): quantile clip tracking.

Counterpart of repro/core/adaptive_clip.py, on tensors.  Each round every
client reports one bit b_i = 1{||Delta~_i|| <= C}; the server privatizes the
bit SUM with Gaussian noise of std sigma_b and tracks the target quantile
gamma with a geometric update

    C <- C * exp(-lr_C * (b_bar - gamma))

so C converges to the gamma-quantile of the unclipped update norms.  C is a
0-d float32 tensor on the run's device: it goes to the ``dp_aggregate``
kernel as a device scalar, and no step of the update reads it on the host.
The bit noise is a materialized N(0, 1) (``RoundNoise.bit``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdaptiveClipConfig", "AdaptiveClipState", "init_state", "update_clip",
           "update_clip_from_stats", "adaptive_clip_rho"]


@dataclasses.dataclass(frozen=True)
class AdaptiveClipConfig:
    """Quantile-tracking knobs (Andrew et al. 2021): target gamma, geometric lr, bit noise."""
    gamma: float = 0.5        # target quantile of update norms
    lr: float = 0.2           # geometric-update learning rate
    sigma_b: float = 10.0     # std of the noise on the bit SUM
    c_min: float = 1e-3
    c_max: float = 1e3


@dataclasses.dataclass
class AdaptiveClipState:
    """Carry of the adaptive-clip tracker: the current threshold C (0-d float32 tensor)."""
    clip: torch.Tensor


def init_state(c0: float, device="cpu") -> AdaptiveClipState:
    """Fresh tracker state at threshold ``c0`` on ``device`` (filled there, not copied)."""
    return AdaptiveClipState(clip=torch.full((), c0, dtype=torch.float32, device=device))


def update_clip(bit_noise, state: AdaptiveClipState, raw_norms: torch.Tensor,
                cfg: AdaptiveClipConfig) -> tuple[AdaptiveClipState, torch.Tensor]:
    """One round of quantile tracking from the (M,) UNclipped update norms.

    Returns (new state, noisy fraction b_bar used for the update).
    """
    bits = (raw_norms <= state.clip).to(torch.float32)
    return update_clip_from_stats(bit_noise, state, torch.sum(bits), raw_norms.shape[0], cfg)


def update_clip_from_stats(bit_noise, state: AdaptiveClipState, count_below, m,
                           cfg: AdaptiveClipConfig) -> tuple[AdaptiveClipState, torch.Tensor]:
    """Quantile update from the bit SUM ``count_below = sum_i 1{||Delta~_i|| <= C}``.

    ``bit_noise`` is the round's N(0, 1) draw (a host 0-d tensor or float);
    ``m`` the client count.
    """
    noisy_sum = count_below + cfg.sigma_b * bit_noise
    b_bar = torch.clamp(noisy_sum / m, 0.0, 1.0)
    new_c = state.clip * torch.exp(-cfg.lr * (b_bar - cfg.gamma))
    new_c = torch.clamp(new_c, cfg.c_min, cfg.c_max)
    return AdaptiveClipState(clip=new_c), b_bar


def adaptive_clip_rho(sigma_b: float, rounds: int) -> float:
    """zCDP-style rate of the bit-sum release over T rounds.

    Each bit has sensitivity 1 (client-level), so one round is
    (alpha, alpha/(2 sigma_b^2))-RDP; T rounds compose linearly.
    """
    return rounds / (2.0 * sigma_b**2)
