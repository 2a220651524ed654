"""Server-side aggregation of client updates + the FedEXP round statistics.

Counterpart of repro/core/aggregation.py.  The server needs three reductions
per round (Algorithms 1 & 2):

    cbar      = (1/M) sum_i c_i                  -- the pseudo-gradient
    mean_sq   = (1/M) sum_i ||c_i||^2            -- FedEXP numerator statistic
    agg_sq    = ||cbar||^2                       -- FedEXP denominator

``aggregate_stats`` is the plain reference; ``fused_clip_aggregate`` clips,
optionally adds per-client noise and reduces, through one of three backends:

    "kernel"        the CUDA ``dp_aggregate`` kernel, fed a materialized
                    (M, d) noise matrix when noise is asked for (drawn by the
                    noise-only kernel from ``noise_seed``).
    "kernel-fused"  the same kernel drawing the noise inside it from
                    ``noise_seed``: no (M, d) noise matrix exists.
    "torch"         the plain PyTorch version, on whatever device the
                    tensors lie.
    "auto"          kernel-fused (noise requested) or kernel for a CUDA
                    tensor; torch for a CPU tensor.

The kernel wrappers themselves run their plain version on a CPU tensor, so
every backend computes the same function, with the same noise for a seed.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "RoundStats",
    "RoundMoments",
    "aggregate_stats",
    "fused_clip_aggregate",
    "resolve_backend",
]

_BACKENDS = ("kernel", "kernel-fused", "torch")


@dataclasses.dataclass
class RoundStats:
    """Aggregate statistics of one federated round (all 0-dim tensors but cbar)."""

    cbar: torch.Tensor           # (d,) mean of released updates
    mean_sq: torch.Tensor        # mean_i ||c_i||^2
    agg_sq: torch.Tensor         # ||cbar||^2
    mean_sq_clipped: torch.Tensor | None = None  # mean_i ||clip(Delta_i)||^2 (pre-noise)


@dataclasses.dataclass
class RoundMoments:
    """Partial SUMS of one round's release; moments of disjoint client sets add."""

    sum_c: torch.Tensor           # (d,) sum of released updates
    sum_sq: torch.Tensor          # sum_i ||c_i||^2 (post-noise)
    sum_sq_clipped: torch.Tensor  # sum_i ||clip(Delta_i)||^2 (pre-noise)
    count: torch.Tensor | float   # number of clients (sum of row weights)

    def stats(self) -> RoundStats:
        """Normalize global sums into the RoundStats the step-size rules eat."""
        cbar = self.sum_c / self.count
        return RoundStats(cbar=cbar, mean_sq=self.sum_sq / self.count,
                          agg_sq=torch.sum(cbar * cbar),
                          mean_sq_clipped=self.sum_sq_clipped / self.count)


def aggregate_stats(updates: torch.Tensor) -> RoundStats:
    """Reference reductions over an ``(M, d)`` matrix of released updates."""
    m = updates.shape[0]
    cbar = updates.sum(dim=0) / m
    mean_sq = torch.sum(updates * updates) / m
    return RoundStats(cbar=cbar, mean_sq=mean_sq, agg_sq=torch.sum(cbar * cbar))


def resolve_backend(backend: str | None, device, *, wants_noise_gen: bool = False) -> str:
    """Map "auto"/None to a concrete backend for a tensor on ``device``."""
    if backend in (None, "auto"):
        if torch.device(device).type == "cuda":
            return "kernel-fused" if wants_noise_gen else "kernel"
        return "torch"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         f"use 'auto' or one of {_BACKENDS}")
    return backend


def fused_clip_aggregate(
    raw_updates: torch.Tensor,
    clip_norm,
    noise: torch.Tensor | None = None,
    *,
    noise_seed: int | None = None,
    noise_sigma=None,
    backend: str = "auto",
    row_start: int = 0,
) -> RoundStats:
    """Clip rows to L2 <= C, optionally add per-client noise, and reduce.

    Args:
      raw_updates: (M, d) raw client updates.
      clip_norm: clipping threshold C (``inf`` releases the rows unclipped): a
        float, or a 0-d float32 tensor on the updates' device that the kernel
        reads there (an adaptive threshold that changes every round).
      noise: optional pre-materialized (M, d) noise matrix (LDP Gaussian);
        None for CDP (noise is added to the mean by the caller, which needs
        ``mean_sq_clipped``).
      noise_seed: 32-bit seed of the per-client Gaussian noise of std
        ``noise_sigma``, keyed by (seed, global row, column).  Mutually
        exclusive with ``noise``.
      noise_sigma: noise std, with ``noise_seed``.
      backend: "auto" | "kernel" | "kernel-fused" | "torch" (module doc).
      row_start: global client index of row 0 (the noise's row key).

    Returns RoundStats where ``mean_sq`` is computed on the released c_i and
    ``mean_sq_clipped`` on the clipped deltas (pre-noise).
    """
    if noise is not None and noise_seed is not None:
        raise ValueError("pass either a materialized `noise` or `noise_seed`, not both")
    if noise_seed is not None and noise_sigma is None:
        # without this the fused path would default sigma to 0 and silently
        # release UN-noised updates — a privacy-guarantee violation
        raise ValueError("`noise_seed` requires `noise_sigma`")
    from repro_torch.kernels.dp_aggregate import ops, ref

    m, d = raw_updates.shape
    backend = resolve_backend(backend, raw_updates.device,
                              wants_noise_gen=noise_seed is not None)
    if backend == "kernel-fused":
        return ops.dp_aggregate(raw_updates, clip_norm, noise_seed=noise_seed,
                                noise_sigma=noise_sigma, row_start=row_start)
    if noise_seed is not None:
        if backend == "kernel":
            noise = ops.generate_ldp_noise(m, d, noise_seed, noise_sigma,
                                           device=raw_updates.device, row_start=row_start)
        else:
            noise = ref.ldp_noise_ref(m, d, noise_seed, noise_sigma, row_start=row_start,
                                      device=raw_updates.device)
    if backend == "kernel":
        return ops.dp_aggregate(raw_updates, clip_norm, noise)
    return RoundMoments(*ref.dp_aggregate_ref(raw_updates, noise, clip_norm), count=m).stats()
