"""Composable algorithm stack: privacy mechanism x aggregation x global step.

Counterpart of repro/core/compose.py, holding what the paper's noiseless,
Gaussian and PrivUnit algorithms, server optimizers, adaptive clipping,
noise schedules and heterogeneous privacy need, in the dense round and in
the masked-moment round of a sampled cohort:

    PrivacyMechanism   clipping + noise + the step-size bias correction + the
                       accounting of its release: ``NoPrivacy``,
                       ``GaussianLDP``, ``PerClientGaussian`` (a sigma per
                       client from its own epsilon), ``PrivUnitLDP``,
                       ``CentralGaussian`` (fixed sigma or the adaptive-clip
                       noise multiplier ``z_mult``), ``NoiseSchedule``
                       (sigma(t) over a fixed-sigma Gaussian).
    Aggregation        ``MeanAggregation``, the paper's uniform mean,
                       ``WeightedAggregation`` (public per-client weights
                       applied after each release), and the compressed
                       layers ``RandKAggregation`` and
                       ``CountSketchAggregation`` (``with_compression``).
    GlobalStep         ``FixedEta`` (DP-FedAvg), ``FedEXPStep`` (the paper's
                       adaptive extrapolation, Eqs. 2/6/7/8), ``ServerOpt``
                       (server Adam / momentum) and ``AdaptiveClipStep``
                       (quantile-tracked clip threshold, Andrew et al. 2021).

Every Gaussian release reduces through ``fused_clip_aggregate`` (dense) or
``partial_clip_moments`` (masked): on the card that is the CUDA
``dp_aggregate`` kernel (fused noise for ``GaussianLDP``, none mode for
``CentralGaussian`` and, with C = inf, for ``NoPrivacy``), one launch a
round, with the cohort mask as the kernel's row gate.  Under
``AdaptiveClipStep`` the clip threshold C is a 0-d tensor on the device that
the kernel reads there.  ``PrivUnitLDP`` is plain PyTorch, as it reaches no
kernel in the JAX package; so are weighted sums and per-row sigmas, which
the kernel does not take (``PerClientGaussian`` draws its unit noise with
the noise-only kernel).

Randomness (``repro_torch.core.algorithm``): ``draw`` methods take what the
round consumes from its generator, mechanism first, then step, always for
the whole cohort of M clients; ``release``, ``moments`` and ``apply`` only
read the resulting ``RoundNoise``, a block of clients its rows at their
global indices.  ``release`` and ``extrapolation`` take ``clip``: None for
the mechanism's own static ``clip_norm``, or the step's per-round override.

Compression (``core.compression``): a compressed layer reduces each round
to a (kc,) sum of linearly compressed rows under the round's plan
(``RoundNoise.plan``, drawn from its own generator), then the server adds
central noise in the compressed domain, decompresses, applies error
feedback and the top-k selection, and steps.  Only mechanisms whose noise
comes after the reduction (``NoPrivacy``, ``CentralGaussian`` and its
schedule) compose with it.  The compressed sums are plain PyTorch: no
``dp_aggregate`` launch, as the JAX package bypasses its kernel there.
DP-SCAFFOLD is ``core.variance_reduction``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import accounting, compression, stepsize
from repro_torch.core import adaptive_clip as ac
from repro_torch.core import mechanisms as mech
from repro_torch.core.aggregation import (
    RoundMoments,
    RoundStats,
    aggregate_stats,
    fused_clip_aggregate,
    global_client_indices,
    partial_clip_moments,
    raw_moments,
    row_keys,
)
from repro_torch.core.algorithm import (
    RoundAux,
    RoundNoise,
    ServerAlgorithm,
    device_copy,
    device_normal,
    draw_seed32,
    rows_at,
    stage_fields,
)

__all__ = [
    "PrivacyMechanism",
    "NoPrivacy",
    "GaussianLDP",
    "PerClientGaussian",
    "PrivUnitLDP",
    "CentralGaussian",
    "NoiseSchedule",
    "Aggregation",
    "MeanAggregation",
    "WeightedAggregation",
    "RandKAggregation",
    "CountSketchAggregation",
    "CompressionCarry",
    "with_compression",
    "GlobalStep",
    "FixedEta",
    "FedEXPStep",
    "ServerOpt",
    "AdaptiveClipStep",
    "ComposedAlgorithm",
    "compose_algorithm",
]


# ---------------------------------------------------------------------------
# Privacy mechanisms
# ---------------------------------------------------------------------------

class PrivacyMechanism:
    """One client randomizer + its clipping regime + its accounting.

        draw(gen, m, d, device)                 -> RoundNoise fields it consumes
                                                (d: the released vector's width,
                                                kc under compression)
        release(noise, deltas, clip)            dense (M, d) -> (RoundStats, extras)
        moments(noise, deltas, mask, start, clip, row_weights)
                                                -> (RoundMoments, extras) partial SUMS
        finalize(noise, mom, extras, clip, m_eff)
                                                cohort moments -> (RoundStats, extras')
        extrapolation(noise, stats, extras, dim, clip, m_eff)
                                                -> (eta_g, eta_naive, eta_target)
        compressed_noise(noise, shape, clip, m_eff, sens_factor)
                                                -> noise of a compressed mean, or None
        budget(delta, rounds, dim, sampling_q, with_numerator) -> PrivacyReport
    """

    is_private = True
    needs_xi_key = False            # CDP-style post-aggregation numerator noise
    is_round_indexed = False        # NoiseSchedule: resolved per round by at_round(t)
    # only a release whose noise comes after the reduction (central noise, or
    # none) can ride a compressed sum; an LDP release is a full R^d vector a
    # client, so ComposedAlgorithm refuses to compress it
    supports_compression = False
    n_scalar_extras = 0             # scalar sums beside the moments (communication model)

    def at_round(self, t):
        """The mechanism governing round ``t`` (self unless round-indexed)."""
        return self

    @property
    def clip_independent_budget(self) -> bool:
        """True when the guarantee does not move with the clip threshold (so an
        AdaptiveClipStep override keeps the budget sound)."""
        return False

    def _clip(self, clip):
        return getattr(self, "clip_norm", None) if clip is None else clip

    def draw(self, gen: torch.Generator, m: int, d: int, device) -> dict:
        """The ``RoundNoise`` fields this release consumes, drawn from ``gen``."""
        return {}

    def release(self, noise: RoundNoise, deltas: torch.Tensor, clip=None):
        """Dense release: clip + randomize + reduce M rows to ``(RoundStats, extras)``."""
        raise NotImplementedError

    def moments(self, noise: RoundNoise, deltas: torch.Tensor, mask, start, clip=None,
                row_weights=None, *, binary_mask: bool = False):
        """Partial SUMS of the release over the masked rows of a block of
        clients at ``start`` (``ServerAlgorithm``); ``binary_mask``: the
        caller knows the mask is {0, 1}."""
        raise NotImplementedError

    def finalize(self, noise: RoundNoise, mom: RoundMoments, extras: dict, clip, m_eff):
        """The cohort's moments -> the ``RoundStats`` the step reads."""
        return mom.stats(), {}

    def compressed_noise(self, noise: RoundNoise, shape, clip, m_eff, sens_factor):
        """The noise of a compressed mean of ``shape``, or None when the release
        adds none; ``sens_factor`` is the compressor's bound on a row's growth."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support compressed aggregation")

    def extrapolation(self, noise: RoundNoise, stats: RoundStats, extras: dict, dim: int,
                      clip, m_eff):
        """This mechanism's debiased step size: ``(eta_g, eta_naive, eta_target)``."""
        raise NotImplementedError

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Privacy budget of a ``rounds``-round run of this release (``PrivacyReport``)."""
        raise ValueError(f"{type(self).__name__} is not a private mechanism")


@dataclasses.dataclass(frozen=True)
class NoPrivacy(PrivacyMechanism):
    """No clipping, no noise: the FedAvg/FedEXP reference release.

    It reduces through the kernel's none mode with C = inf (every scale is
    1), so the noiseless names take the same one-pass reduction on the card.
    """

    is_private = False
    supports_compression = True     # nothing to privatize

    def release(self, noise, deltas, clip=None):
        """Dense release: the three reductions of the unclipped rows."""
        s = fused_clip_aggregate(deltas, math.inf)
        return RoundStats(cbar=s.cbar, mean_sq=s.mean_sq, agg_sq=s.agg_sq), {}

    def moments(self, noise, deltas, mask, start, clip=None, row_weights=None, *,
                binary_mask=False, compress_fn=None, compress_row_bound=None):
        """The unclipped rows' sums, weighted by the mask (``raw_moments``)."""
        return raw_moments(deltas, mask, row_weights, binary_mask=binary_mask,
                           compress_fn=compress_fn), {}

    def compressed_noise(self, noise, shape, clip, m_eff, sens_factor):
        """No release noise."""
        return None

    def extrapolation(self, noise, stats, extras, dim, clip, m_eff):
        """Eq. (2) on the unprivatized statistics."""
        return stepsize.fedexp(stats.mean_sq, stats.agg_sq), None, None


@dataclasses.dataclass(frozen=True)
class GaussianLDP(PrivacyMechanism):
    """Per-client clip + Gaussian noise (the paper's LDP setting).

    The noise of client i, column j is keyed by (round seed, i, j), so the
    fused kernel, the noise-only kernel and the plain version draw the same
    matrix.  A ``RoundNoise.ldp`` matrix, when given, replaces it.
    """

    clip_norm: float
    sigma: float
    backend: str = "auto"

    def draw(self, gen, m, d, device):
        """The round's 32-bit noise seed."""
        return {"seed": draw_seed32(gen)}

    def release(self, noise, deltas, clip=None):
        """Dense release: clip, add sigma * N(0, 1) per client, reduce."""
        c = self._clip(clip)
        if noise.ldp is not None:
            return fused_clip_aggregate(deltas, c, noise.ldp, backend=self.backend), {}
        return fused_clip_aggregate(deltas, c, noise_seed=noise.seed, noise_sigma=self.sigma,
                                    backend=self.backend), {}

    def moments(self, noise, deltas, mask, start, clip=None, row_weights=None, *,
                binary_mask=False):
        """The masked release's sums; each row's noise is its client's."""
        c, m = self._clip(clip), deltas.shape[0]
        if noise.ldp is not None:
            return partial_clip_moments(deltas, c, rows_at(noise.ldp, start, m),
                                        weight_mask=mask, row_weights=row_weights,
                                        backend=self.backend), {}
        return partial_clip_moments(deltas, c, noise_seed=noise.seed, noise_sigma=self.sigma,
                                    start=start, weight_mask=mask, row_weights=row_weights,
                                    backend=self.backend), {}

    def extrapolation(self, noise, stats, extras, dim, clip, m_eff):
        """Eq. (6), with the naive (Eq. 3) and target (Eq. 5) diagnostics."""
        eta = stepsize.ldp_gaussian(stats.mean_sq, stats.agg_sq, dim, self.sigma)
        return (eta,
                stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                stepsize.target(stats.mean_sq_clipped, stats.agg_sq))

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Per-release local guarantee (Prop. 4.1), whatever the step."""
        return accounting.ldp_gaussian_budget(self.clip_norm, self.sigma, delta)


def _rows_of(values: torch.Tensor, start, m: int) -> torch.Tensor:
    """A block's rows of a per-client (M,) vector, zero past M (padding), on
    the vector's device."""
    if isinstance(start, torch.Tensor):
        padded = torch.cat([values, values.new_zeros(1)])
        idx = global_client_indices(start, m, values.device)
        return padded[torch.clamp(idx, max=values.shape[0])]
    rows = values[int(start):int(start) + m]
    return torch.cat([rows, values.new_zeros(m - rows.shape[0])]) if rows.shape[0] < m else rows


@dataclasses.dataclass(frozen=True)
class PerClientGaussian(PrivacyMechanism):
    """Heterogeneous-privacy Gaussian LDP: client i carries its own epsilon.

    sigma_i comes from (eps_i, delta) at sensitivity 2C
    (``mechanisms.per_client_sigmas``, float64 on the host), indexed by
    global client index as ``WeightedAggregation.weights`` are.  Row i's
    noise is client i's unit-sigma stream (the kernels' Threefry noise at
    sigma 1, or ``RoundNoise.ldp`` read as N(0, 1)) times sigma_i.  The
    FedEXP correction subtracts ``d * mean(sigma_i^2)`` over the realized
    cohort (``stepsize.ldp_gaussian_mixed``).  When every epsilon is equal
    the release is ``GaussianLDP``'s with the common sigma, expression for
    expression.  ``inverse_variance_weights()`` are the public 1/sigma_i^2
    weights that ``ldp-fedexp-perclient`` aggregates with.
    """

    clip_norm: float
    epsilons: tuple[float, ...]
    delta: float
    backend: str = "auto"

    def __post_init__(self):
        from repro_torch.core import mechanisms as _mech
        eps = tuple(float(e) for e in self.epsilons)
        if not eps:
            raise ValueError("PerClientGaussian requires per-client epsilons")
        object.__setattr__(self, "epsilons", eps)
        sigmas = _mech.per_client_sigmas(eps, self.delta, self.clip_norm)
        object.__setattr__(self, "sigmas", sigmas)
        object.__setattr__(self, "_uniform", len(set(sigmas)) == 1)
        object.__setattr__(self, "_sigma_host", torch.tensor(sigmas, dtype=torch.float32))

    @property
    def n_scalar_extras(self):
        """The cohort's sum of sigma_i^2 rides beside the moments when sigmas differ."""
        return 0 if self._uniform else 1

    def inverse_variance_weights(self) -> tuple[float, ...]:
        """Public 1/sigma_i^2 aggregation weights (for ``WeightedAggregation``)."""
        return tuple(1.0 / (s * s) for s in self.sigmas)

    def _sigma_rows(self, start, m: int, device) -> torch.Tensor:
        """(m,) float32 sigmas of a block of clients on ``device`` (0 past M),
        from the table's copy there."""
        return _rows_of(device_copy(self, "sigmas", self._sigma_host, device), start, m)

    def draw(self, gen, m, d, device):
        """The round's 32-bit noise seed."""
        return {"seed": draw_seed32(gen)}

    def _noise(self, noise, shape, start, device) -> torch.Tensor:
        """The block's noise: each client's unit-sigma rows times its sigma."""
        from repro_torch.kernels.dp_aggregate import ops
        m, d = shape
        if noise.ldp is not None:
            unit = rows_at(noise.ldp, start, m)
        else:
            unit = ops.generate_ldp_noise(m, d, noise.seed, 1.0, device=device,
                                          **row_keys(start, device))
        return unit * self._sigma_rows(start, m, device)[:, None]

    def _uniform_noise(self, noise, start, m) -> dict:
        """GaussianLDP's noise arguments at the common sigma."""
        if noise.ldp is not None:
            return {"noise": self.sigmas[0] * rows_at(noise.ldp, start, m)}
        return {"noise_seed": noise.seed, "noise_sigma": self.sigmas[0]}

    def release(self, noise, deltas, clip=None):
        """Dense release: clip, add sigma_i * N(0, 1) to row i, reduce."""
        c, m = self._clip(clip), deltas.shape[0]
        if self._uniform:
            return fused_clip_aggregate(deltas, c, **self._uniform_noise(noise, 0, m),
                                        backend=self.backend), {}
        stats = fused_clip_aggregate(deltas, c, self._noise(noise, deltas.shape, 0, deltas.device),
                                     backend=self.backend)
        sig_sq = torch.square(self._sigma_rows(0, m, deltas.device))
        return stats, {"mean_sigma_sq": torch.sum(sig_sq) / m}

    def moments(self, noise, deltas, mask, start, clip=None, row_weights=None, *,
                binary_mask=False):
        """The masked release's sums, and the cohort's sum of sigma_i^2."""
        c, m = self._clip(clip), deltas.shape[0]
        if self._uniform:
            kw = self._uniform_noise(noise, start, m)
            if "noise_seed" in kw:
                kw["start"] = start
            return partial_clip_moments(deltas, c, weight_mask=mask, row_weights=row_weights,
                                        backend=self.backend, **kw), {}
        mom = partial_clip_moments(deltas, c, self._noise(noise, deltas.shape, start,
                                                          deltas.device),
                                   weight_mask=mask, row_weights=row_weights,
                                   backend=self.backend)
        sig_sq = torch.square(self._sigma_rows(start, m, deltas.device))
        if mask is None and row_weights is None:
            return mom, {"sum_sigma_sq": torch.sum(sig_sq)}
        v = (row_weights if mask is None else mask if row_weights is None
             else mask * row_weights)
        return mom, {"sum_sigma_sq": v @ sig_sq}

    def finalize(self, noise, mom, extras, clip, m_eff):
        """The cohort's stats, and its mean sigma^2 when sigmas differ."""
        if self._uniform:
            return mom.stats(), {}
        return mom.stats(), {"mean_sigma_sq": extras["sum_sigma_sq"] / mom.count}

    def extrapolation(self, noise, stats, extras, dim, clip, m_eff):
        """Eq. (6) with the cohort's mean sigma^2, and the diagnostics."""
        if self._uniform:
            eta = stepsize.ldp_gaussian(stats.mean_sq, stats.agg_sq, dim, self.sigmas[0])
        else:
            eta = stepsize.ldp_gaussian_mixed(stats.mean_sq, stats.agg_sq, dim,
                                              extras["mean_sigma_sq"])
        return (eta,
                stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                stepsize.target(stats.mean_sq_clipped, stats.agg_sq))

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Worst-client budget: the LDP guarantee of the smallest sigma; every
        other client's release is more private."""
        rep = accounting.ldp_gaussian_budget(self.clip_norm, min(self.sigmas), delta)
        return dataclasses.replace(
            rep, setting=f"LDP (Gaussian, per-client worst of {len(self.epsilons)})")


@dataclasses.dataclass(frozen=True)
class PrivUnitLDP(PrivacyMechanism):
    """Per-client clip + PrivUnit direction x ScalarDP magnitude (pure LDP).

    With a clip override (adaptive clipping) the ScalarDP lattice built at
    ``clip_norm`` is reused through exact public rescaling: rows are released
    on the reference scale and multiplied back by ``clip / clip_norm``
    (ScalarDP's debias transform is linear in ``r_max``, so this is the
    r_max = clip release).  Plain PyTorch: the release reaches no kernel.
    """

    clip_norm: float
    eps0: float
    eps1: float
    eps2: float
    dim: int

    n_scalar_extras = 1             # the sum of s_hat rides beside the moments

    def __post_init__(self):
        object.__setattr__(self, "pu", mech.make_privunit_params(self.dim, self.eps0, self.eps1))
        object.__setattr__(self, "sc", mech.make_scalardp_params(self.eps2, self.clip_norm))

    @property
    def clip_independent_budget(self) -> bool:
        """Pure (eps0+eps1+eps2)-LDP at any clip threshold."""
        return True

    def draw(self, gen, m, d, device):
        """Per client: the cap and quantile uniforms and ScalarDP's rounding
        uniform, keep uniform and integer in [0, k), on the host; and the
        32-bit seed of the direction's N(0, 1) normal.  The normal of client
        i, column j is keyed by (seed, i, j), as the Gaussian LDP noise is
        (the noise-only kernel on the card, ``ref.ldp_noise_ref`` on the CPU),
        so a block of clients (a streamed chunk, a gathered block) draws only
        its own rows: no (M, d) normal exists.  A ``RoundNoise.g`` matrix,
        when given, replaces it."""
        fields = {f: torch.rand(m, generator=gen) for f in ("cap_u", "u01", "round_u", "keep_u")}
        fields["u_int"] = torch.randint(0, self.sc.k, (m,), generator=gen, dtype=torch.int32)
        fields["seed"] = draw_seed32(gen)
        return fields

    def stage(self, noise) -> dict:
        """The staged form's fields: the (M,) quantiles computed on the host in
        float64 from the cap and quantile uniforms, as float32, in their
        place."""
        t = mech.privunit_quantile(noise.cap_u, noise.u01, self.pu).to(torch.float32)
        return {"quantile": t, "cap_u": None, "u01": None}

    def _normal(self, noise, shape, start, device) -> torch.Tensor:
        """The block's rows of the directions' N(0, 1) normal."""
        if noise.g is not None:
            return rows_at(noise.g, start, shape[0])
        from repro_torch.kernels.dp_aggregate import ops
        return ops.generate_ldp_noise(*shape, noise.seed, 1.0, device=device,
                                      **row_keys(start, device))

    def _randomize(self, noise, deltas, clip, start=0):
        """Per-client clip + PrivUnit release of the block of clients at
        ``start``: (released, clipped) rows."""
        dev = deltas.device
        g = self._normal(noise, deltas.shape, start, dev)
        c = self._clip(clip)
        norms = torch.linalg.vector_norm(deltas, dim=-1)
        clipped = deltas * torch.clamp(c / torch.clamp(norms, min=1e-12), max=1.0)[:, None]
        if noise.quantile is None:
            raise ValueError("PrivUnit releases the staged form of the round's noise, which "
                             "holds its quantiles (stage_noise)")
        draws = [noise.quantile, g, noise.round_u, noise.keep_u, noise.u_int]
        if clip is None:
            released = mech.privunit_randomize(clipped, *draws, self.pu, self.sc)
        else:  # the release on the reference scale, rescaled publicly
            to_ref = self.clip_norm / c
            released = mech.privunit_randomize(clipped * to_ref, *draws,
                                               self.pu, self.sc) / to_ref
        return released, clipped

    def _s_hat(self, released, clip):
        if clip is None:
            return mech.estimate_norm_sq(released, self.pu, self.sc)
        to_ref = self.clip_norm / self._clip(clip)
        return mech.estimate_norm_sq(released * to_ref, self.pu, self.sc) / torch.square(to_ref)

    def release(self, noise, deltas, clip=None):
        """Dense release: clip, randomize, reduce; extras hold mean_i s_hat_i."""
        m = deltas.shape[0]
        released, clipped = self._randomize(noise, deltas, clip)
        stats = aggregate_stats(released)
        stats.mean_sq_clipped = torch.sum(torch.sum(torch.square(clipped), dim=-1)) / m
        return stats, {"mean_s_hat": torch.sum(self._s_hat(released, clip)) / m}

    def moments(self, noise, deltas, mask, start, clip=None, row_weights=None, *,
                binary_mask=False):
        """The masked release's sums over the block's clients, each randomized
        with its own draws (the rows of the cohort's at its global index);
        masked rows where-zeroed in both the released and the clipped sets,
        each other row weighted by its mask value (and weight).  ``mask``
        None (every row in, no weights) sums as the dense release does."""
        m, n = deltas.shape[0], noise.round_u.shape[0]
        if not (isinstance(start, int) and start == 0 and n == m):
            # a streamed chunk's padding rows past M (mask 0) read client
            # M - 1's draws; their release is zeroed below
            idx = torch.clamp(global_client_indices(start, m, noise.round_u.device), max=n - 1)
            rows = {f: getattr(noise, f)[idx] for f in ("quantile", "round_u", "keep_u", "u_int")}
            noise = dataclasses.replace(noise, **rows)
        released, clipped = self._randomize(noise, deltas, clip, start)
        if mask is None and row_weights is None:
            # every row in, summed as the dense release reduces them
            sq_clipped = torch.sum(torch.sum(torch.square(clipped), dim=-1))
            mom = RoundMoments(sum_c=released.sum(dim=0), sum_sq=torch.sum(released * released),
                               sum_sq_clipped=sq_clipped, count=float(m))
            return mom, {"sum_s_hat": torch.sum(self._s_hat(released, clip))}
        if mask is None:
            mask = deltas.new_ones(m)
        keep = (mask > 0)[:, None]
        released = torch.where(keep, released, 0.0)
        clipped = torch.where(keep, clipped, 0.0)
        v = mask if row_weights is None else mask * row_weights
        mom = RoundMoments(sum_c=v @ released,
                           sum_sq=v @ torch.sum(torch.square(released), dim=-1),
                           sum_sq_clipped=v @ torch.sum(torch.square(clipped), dim=-1),
                           count=torch.sum(v))
        return mom, {"sum_s_hat": v @ self._s_hat(released, clip)}

    def finalize(self, noise, mom, extras, clip, m_eff):
        """The cohort's stats and mean s_hat."""
        return mom.stats(), {"mean_s_hat": extras["sum_s_hat"] / mom.count}

    def extrapolation(self, noise, stats, extras, dim, clip, m_eff):
        """Eq. (7), with the naive (Eq. 3) and target (Eq. 5) diagnostics."""
        eta = stepsize.ldp_privunit(extras["mean_s_hat"], stats.agg_sq)
        return (eta,
                stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                stepsize.target(stats.mean_sq_clipped, stats.agg_sq))

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Lemma B.1: pure (eps0 + eps1 + eps2)-LDP per release."""
        return accounting.privunit_budget(self.eps0, self.eps1, self.eps2)


@dataclasses.dataclass(frozen=True)
class CentralGaussian(PrivacyMechanism):
    """Clip-only clients + server-side Gaussian noise on the mean (CDP).

    Two noise modes:
      * fixed ``sigma`` (the paper): server noise std ``sigma / sqrt(M)``
        with the static configured client count, the release Proposition
        4.2 accounts;
      * ``z_mult`` (adaptive clipping, Andrew et al.): std ``z C / sqrt(m)``
        tracking the current clip threshold and the realized cohort size, so
        the guarantee is C-independent.
    """

    clip_norm: float | None = None
    sigma: float | None = None
    num_clients: int = 0
    sigma_xi: float | None = None     # numerator noise; None = d sigma^2 / M
    z_mult: float | None = None       # adaptive mode: sigma = z * C
    backend: str = "auto"

    needs_xi_key = True
    supports_compression = True     # the noise comes after the reduction

    def __post_init__(self):
        if (self.sigma is None) == (self.z_mult is None):
            raise ValueError("set exactly one of sigma (fixed) / z_mult (adaptive)")
        if self.sigma is not None and self.clip_norm is None:
            raise ValueError("fixed-sigma CentralGaussian requires clip_norm")
        if self.num_clients < 1:
            raise ValueError("CentralGaussian requires num_clients >= 1")

    @property
    def clip_independent_budget(self) -> bool:
        """True in the z mode: the noise tracks z C, so C cancels."""
        return self.z_mult is not None

    def _sigma(self, clip):
        return self.sigma if self.z_mult is None else self.z_mult * self._clip(clip)

    def _m_noise(self, m_eff):
        """Divisor of the server-noise std: the static configured M for the
        fixed-sigma release, the realized cohort for the z-tracking one (a
        count on the device floored at 1, as the reference floors a traced
        count; a host count as it is)."""
        if self.z_mult is None:
            return float(self.num_clients)
        return torch.clamp(m_eff, min=1.0) if isinstance(m_eff, torch.Tensor) else m_eff

    def _noised(self, noise, cbar, clip, m_eff):
        """cbar + sigma / sqrt(m) * N(0, 1) on the device."""
        m = self._m_noise(m_eff)
        root = torch.sqrt(m) if isinstance(m, torch.Tensor) else math.sqrt(m)
        return cbar + (self._sigma(clip) / root) * noise.central

    def draw(self, gen, m, d, device):
        """N(0, 1) of the (d,) mean ((kc,) compressed), drawn on the device."""
        return {"central": device_normal(gen, (d,), device)}

    def release(self, noise, deltas, clip=None):
        """Dense release: clip, reduce, then noise the mean."""
        stats = fused_clip_aggregate(deltas, self._clip(clip), None, backend=self.backend)
        cbar = self._noised(noise, stats.cbar, clip, float(deltas.shape[0]))
        return RoundStats(cbar=cbar, mean_sq=stats.mean_sq, agg_sq=torch.sum(cbar * cbar),
                          mean_sq_clipped=stats.mean_sq_clipped), {}

    def moments(self, noise, deltas, mask, start, clip=None, row_weights=None, *,
                binary_mask=False, compress_fn=None, compress_row_bound=None):
        """The clipped rows' sums (none mode); the noise comes in ``finalize``."""
        return partial_clip_moments(deltas, self._clip(clip), None, weight_mask=mask,
                                    row_weights=row_weights, backend=self.backend,
                                    compress_fn=compress_fn,
                                    compress_row_bound=compress_row_bound), {}

    def compressed_noise(self, noise, shape, clip, m_eff, sens_factor):
        """Noise of a compressed mean: a compressed row's sensitivity is
        ``sens_factor`` C, so each cell's std is the dense release's
        ``sigma / sqrt(m)`` times ``sens_factor`` (the C / sigma ratio, hence
        the budget, is the dense release's).  ``RoundNoise.central`` was
        drawn ``shape`` wide."""
        if tuple(noise.central.shape) != tuple(shape):
            raise ValueError(f"central noise of shape {tuple(noise.central.shape)} for a "
                             f"compressed mean of shape {tuple(shape)}")
        m = self._m_noise(m_eff)
        root = torch.sqrt(m) if isinstance(m, torch.Tensor) else math.sqrt(m)
        return (sens_factor * self._sigma(clip) / root) * noise.central

    def finalize(self, noise, mom, extras, clip, m_eff):
        """Normalize, then noise the mean for the realized cohort ``m_eff``."""
        cbar = self._noised(noise, mom.sum_c / mom.count, clip, m_eff)
        return RoundStats(cbar=cbar, mean_sq=mom.sum_sq / mom.count,
                          agg_sq=torch.sum(cbar * cbar),
                          mean_sq_clipped=mom.sum_sq_clipped / mom.count), {}

    def extrapolation(self, noise, stats, extras, dim, clip, m_eff):
        """Eq. (8): the clipped numerator plus sigma_xi * xi, and the target."""
        sigma = self._sigma(clip)
        sigma_xi = (self.sigma_xi if self.sigma_xi is not None
                    else dim * sigma**2 / self._m_noise(m_eff))
        xi = sigma_xi * noise.xi
        eta = stepsize.cdp(stats.mean_sq_clipped, xi, stats.agg_sq)
        return eta, None, stepsize.target(stats.mean_sq_clipped, stats.agg_sq)

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Composed GDP budget of the noised mean (and numerator, with FedEXP)."""
        q = sampling_q
        if self.z_mult is not None:
            # the C/sigma ratio is the constant 1/z: stated in C = 1 units,
            # with the realized cohort's count M/q (the clip-bit release adds
            # adaptive_clip_rho, negligible at sigma_b ~ 10)
            return accounting.cdp_budget(
                1.0, self.z_mult, self.num_clients / q, rounds, delta,
                sigma_xi=(dim * self.z_mult**2 / self.num_clients if with_numerator else None),
                sampling_q=q)
        sigma_xi = None
        if with_numerator:
            sigma_xi = (self.sigma_xi if self.sigma_xi is not None
                        else dim * self.sigma**2 / self.num_clients)
        return accounting.cdp_budget(self.clip_norm, self.sigma, self.num_clients, rounds,
                                     delta, sigma_xi=sigma_xi, sampling_q=q)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule(PrivacyMechanism):
    """Round-indexed noise schedule sigma(t) over a fixed-sigma Gaussian mechanism.

    A configuration wrapper: it never releases itself.  ``at_round(t)``
    resolves it to the inner mechanism with ``sigma = sigma(t)``, a host
    float (the loop knows t), where

        sigma(t) = sigma0 * decay**t * step_factor(t)

    in float32 as the JAX package traces it; ``step_factor`` is 1 before the
    first boundary and ``scales[i]`` from ``boundaries[i]`` on.  A constant
    schedule (decay 1, no boundaries) resolves to the inner mechanism object
    unchanged.  ``budget`` composes the sequence (``schedule_ldp_budget`` /
    ``schedule_cdp_budget``) from the float64 ``sigma_value``; a constant
    schedule reports the inner mechanism's budget.
    """

    inner: PrivacyMechanism = None
    decay: float = 1.0
    boundaries: tuple[int, ...] = ()
    scales: tuple[float, ...] = ()

    def __post_init__(self):
        if not isinstance(self.inner, (GaussianLDP, CentralGaussian)):
            raise ValueError(
                "NoiseSchedule wraps a fixed-sigma Gaussian mechanism "
                f"(GaussianLDP or CentralGaussian); got {type(self.inner).__name__}")
        if isinstance(self.inner, CentralGaussian) and self.inner.sigma is None:
            raise ValueError(
                "NoiseSchedule needs a fixed-sigma CentralGaussian; the z_mult "
                "(adaptive-clip) mode already rescales its noise per round and has no "
                "static sigma to schedule")
        if not (isinstance(self.decay, (int, float)) and self.decay > 0):
            raise ValueError(f"decay must be positive, got {self.decay!r}")
        bounds = tuple(int(b) for b in self.boundaries)
        if any(b < 0 for b in bounds) or list(bounds) != sorted(set(bounds)):
            raise ValueError("boundaries must be strictly increasing nonnegative rounds")
        scales = tuple(float(s) for s in self.scales)
        if len(scales) != len(bounds):
            raise ValueError("scales must match boundaries one-to-one")
        if any(s <= 0 for s in scales):
            raise ValueError("scales must be positive")
        object.__setattr__(self, "boundaries", bounds)
        object.__setattr__(self, "scales", scales)

    @property
    def is_constant(self) -> bool:
        """True when sigma(t) == sigma0 for every t."""
        return self.decay == 1.0 and not self.boundaries

    @property
    def is_round_indexed(self):
        """Only a varying schedule needs the round index."""
        return not self.is_constant

    @property
    def needs_xi_key(self):
        """The inner mechanism's numerator noise."""
        return self.inner.needs_xi_key

    @property
    def supports_compression(self):
        """Compression composes when the inner release does."""
        return self.inner.supports_compression

    @property
    def n_scalar_extras(self):
        """The inner release's scalar sums (none for the Gaussians)."""
        return self.inner.n_scalar_extras

    def compressed_noise(self, noise, shape, clip, m_eff, sens_factor):
        """The inner mechanism's (a round resolves the schedule first)."""
        return self.inner.compressed_noise(noise, shape, clip, m_eff, sens_factor)

    def at_round(self, t):
        """The inner mechanism at round ``t``; the inner object itself for a
        constant schedule."""
        if self.is_constant:
            return self.inner
        return dataclasses.replace(self.inner, sigma=self.sigma_at(t))

    def _step_factor(self, t: int) -> float:
        factor = 1.0
        for b, sc in zip(self.boundaries, self.scales):
            if t >= b:
                factor = sc
        return factor

    def sigma_at(self, t: int) -> float:
        """sigma(t) in float32, as the JAX package's traced value: XLA's
        float32 ``power`` is ``exp(t log decay)`` rounded once (numpy's
        float32 ``power`` is off by one ulp in about a fifth of the rounds)."""
        power = np.float32(math.exp(float(t) * math.log(float(np.float32(self.decay)))))
        s = np.float32(self.inner.sigma) * power
        return float(np.float32(s) * np.float32(self._step_factor(t)))

    def sigma_value(self, t: int) -> float:
        """sigma(t) in float64 (the accounting's value)."""
        return float(self.inner.sigma) * float(self.decay) ** int(t) * self._step_factor(t)

    def __getattr__(self, item):
        if item.startswith("__") or item == "inner":
            raise AttributeError(item)
        inner = object.__getattribute__(self, "__dict__").get("inner")
        if inner is None:
            raise AttributeError(item)
        return getattr(inner, item)

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """GDP composition of the non-uniform sigma sequence; a constant
        schedule's is the inner mechanism's own."""
        if self.is_constant:
            return self.inner.budget(delta, rounds=rounds, dim=dim, sampling_q=sampling_q,
                                     with_numerator=with_numerator)
        sigmas = [self.sigma_value(t) for t in range(rounds)]
        if isinstance(self.inner, GaussianLDP):
            return accounting.schedule_ldp_budget(self.inner.clip_norm, sigmas, delta)
        sigma_xis = None
        if with_numerator:
            sigma_xis = [self.inner.sigma_xi if self.inner.sigma_xi is not None
                         else dim * s**2 / self.inner.num_clients for s in sigmas]
        return accounting.schedule_cdp_budget(self.inner.clip_norm, sigmas,
                                              self.inner.num_clients, delta,
                                              sigma_xis=sigma_xis, sampling_q=sampling_q)


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

class Aggregation:
    """How released client updates combine into the round's moments.

    Two capabilities ride this layer: public per-client weights
    (``is_weighted``) and per-round compression (``is_compressed``, a
    linear per-row map to kc floats under the round's plan).  The
    compression methods are identities here."""

    is_weighted = False
    is_compressed = False
    # a compressed row's L2 growth over its dense norm at worst: the moment
    # path re-clips compressed rows to sens_factor C and the central noise
    # scales by it
    sens_factor = 1.0
    uses_error_feedback = False

    def row_weights(self, start, m_local: int, device):
        """Per-client weights of a block of clients at ``start``; None = uniform."""
        return None

    def comm_floats(self, d: int) -> int:
        """Floats of one client's released vector, and of the round's vector sum."""
        return d

    def plan(self, gen: torch.Generator, d: int, device):
        """The round's compression plan drawn from ``gen``; None = dense."""
        return None

    def compress_fn(self, plan):
        """The linear per-row compressor (..., d) -> (..., kc) of ``plan``."""
        return None

    def decompress(self, comp, plan, d: int):
        """The (kc,) compressed mean -> its (d,) estimate."""
        return comp

    def select(self, g):
        """The support kept after decompression (top-k); all of it here."""
        return g


def _as_int(name: str, v) -> int:
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        raise ValueError(f"{name} must be a positive int, got {v!r}")
    return v


@dataclasses.dataclass(frozen=True)
class MeanAggregation(Aggregation):
    """Uniform mean over the cohort — the paper's aggregation."""


@dataclasses.dataclass(frozen=True)
class WeightedAggregation(Aggregation):
    """Public per-client weights applied after each client's DP release: the
    round releases ``sum_i v_i c_i / sum_i v_i``, so each client's guarantee
    is the mechanism's.  ``weights`` is a per-client tuple indexed by global
    client index.  The moment count is a weight sum, not a client count, so
    a sampled round never replaces it with the cohort size."""

    weights: tuple[float, ...] = ()

    is_weighted = True

    def __post_init__(self):
        if not self.weights:
            raise ValueError("WeightedAggregation requires per-client weights")
        if any(w < 0 for w in self.weights) or sum(self.weights) <= 0:
            raise ValueError("weights must be nonnegative with positive sum")
        object.__setattr__(self, "_host", torch.tensor(self.weights, dtype=torch.float32))

    def row_weights(self, start, m_local, device):
        """(m_local,) float32 weights of the block's clients on ``device``;
        padding rows past M weigh 0."""
        return _rows_of(device_copy(self, "weights", self._host, device), start, m_local)


@dataclasses.dataclass(frozen=True)
class RandKAggregation(Aggregation):
    """Unbiased random-k coordinate aggregation.

    Each round keeps k coordinates (the plan, shared by every client), the
    round reduces a (k,) sum, and the server's d/k-scaled scatter is an
    unbiased estimate of the dense mean.  A coordinate projection is an L2
    contraction, so sensitivity stays C (``sens_factor`` 1) and the central
    noise is the dense std per kept coordinate.  k >= d is lossless."""

    k: int

    is_compressed = True

    def __post_init__(self):
        _as_int("k", self.k)

    def comm_floats(self, d: int) -> int:
        """k floats (d when k >= d)."""
        return min(self.k, d)

    def plan(self, gen, d, device):
        """The round's (k,) coordinate indices (``compression.randk_plan``)."""
        return compression.randk_plan(gen, d, min(self.k, d), device)

    def compress_fn(self, plan):
        """The plan's coordinates of each row."""
        return lambda u: compression.randk_compress(u, plan)

    def decompress(self, comp, plan, d):
        """Scatter the (k,) mean back, scaled by d/k."""
        return compression.randk_decompress(comp, plan, d)


@dataclasses.dataclass(frozen=True)
class CountSketchAggregation(Aggregation):
    """Count-sketch aggregation with heavy-hitter recovery.

    Clients sketch their clipped update into depth tables of ``width``
    buckets (the round's shared bucket and sign tables), the round reduces
    the (depth * width,) sketch, and the server unsketches by the median
    over the depth, keeping only the ``top_k`` largest-|.| coordinates when
    set.  The truncation biases the estimate, so ``error_feedback=True``
    carries its residual in the server state (``CompressionCarry``) into the
    next round.  A sketched row's L2 may grow up to sqrt(depth) times a
    clipped one's, so the moment path re-clips compressed rows to
    ``sqrt(depth) C`` (``sens_factor``) and the central noise scales by the
    same factor: the C / sigma ratio the budget reads is unchanged."""

    width: int
    depth: int = 3
    top_k: int | None = None
    error_feedback: bool = False

    is_compressed = True

    def __post_init__(self):
        _as_int("width", self.width)
        _as_int("depth", self.depth)
        if self.top_k is not None:
            _as_int("top_k", self.top_k)
        if self.error_feedback and self.top_k is None:
            raise ValueError(
                "error_feedback without top_k has nothing to feed back: the un-truncated "
                "median unsketch is already the best estimate this sketch offers.  Set "
                "top_k=<support size> (the biased variant EF exists to correct) or drop "
                "error_feedback.")

    @property
    def sens_factor(self):
        """sqrt(depth): the depth sign-hash tables' bound on a row's growth."""
        return math.sqrt(self.depth)

    @property
    def uses_error_feedback(self):
        """Whether the server carries the truncation residual."""
        return self.error_feedback

    def comm_floats(self, d: int) -> int:
        """width * depth floats."""
        return self.width * self.depth

    def plan(self, gen, d, device):
        """The round's (depth, d) bucket ids and signs (``compression.sketch_plan``)."""
        return compression.sketch_plan(gen, d, self.width, self.depth, device)

    def compress_fn(self, plan):
        """Each row's sketch, (..., d) -> (..., depth * width)."""
        return lambda u: compression.sketch_compress(u, plan, self.width)

    def decompress(self, comp, plan, d):
        """The median-of-depth (d,) estimate, untruncated: ``select`` truncates
        after error feedback, so the residual sees the whole estimate."""
        return compression.sketch_decompress(comp, plan, d)

    def select(self, g):
        """The top_k largest-|.| coordinates (all of them when top_k is unset)."""
        return g if self.top_k is None else compression.topk_select(g, self.top_k)


# ---------------------------------------------------------------------------
# Global steps
# ---------------------------------------------------------------------------

class GlobalStep:
    """Server-side update policy + owner of the carry state and its extra draws."""

    stateful = False
    needs_clip_bits = False
    uses_extrapolation = False

    def draw(self, gen: torch.Generator, mechanism: PrivacyMechanism) -> dict:
        """The ``RoundNoise`` fields this step consumes, drawn after the mechanism's."""
        return {}

    def clip_override(self, state):
        """The round's clip threshold from the carry; None = the mechanism's static."""
        return None

    def init(self, w):
        """Initial step-owned carry state."""
        return ()

    def apply(self, noise, w, stats, extras, mechanism, clip, m_eff, state):
        """``-> (w_next, RoundAux, state)`` from the released round statistics."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedEta(GlobalStep):
    """w <- w + eta_g * cbar with a constant eta_g (DP-FedAvg: eta_g = 1)."""

    eta: float = 1.0

    def apply(self, noise, w, stats, extras, mechanism, clip, m_eff, state):
        """Apply the constant step."""
        w_next = w + stats.cbar if self.eta == 1.0 else w + self.eta * stats.cbar
        return w_next, RoundAux(eta_g=torch.full((), self.eta, device=w.device)), state


def _draw_xi(gen, mechanism) -> dict:
    """xi ~ N(0, 1) when the mechanism privatizes the FedEXP numerator."""
    return {"xi": torch.randn((), generator=gen)} if mechanism.needs_xi_key else {}


@dataclasses.dataclass(frozen=True)
class FedEXPStep(GlobalStep):
    """The paper's adaptive extrapolation (Eqs. 2/6/7/8): the mechanism supplies
    its debiased numerator; this step extrapolates by the ratio, floored at 1."""

    uses_extrapolation = True

    def draw(self, gen, mechanism):
        """xi ~ N(0, 1) when the mechanism privatizes the numerator."""
        return _draw_xi(gen, mechanism)

    def apply(self, noise, w, stats, extras, mechanism, clip, m_eff, state):
        """Extrapolate: w + eta_g * cbar (a weighted round's client count
        rides in ``extras["n_clients"]``)."""
        eta, naive, target = mechanism.extrapolation(noise, stats, extras, w.shape[-1], clip,
                                                     extras.get("n_clients", m_eff))
        eta = eta.to(w.device)
        aux = RoundAux(eta_g=eta, eta_naive=naive, eta_target=target,
                       update_norm=eta * torch.linalg.vector_norm(stats.cbar))
        return w + eta * stats.cbar, aux, state


@dataclasses.dataclass(frozen=True)
class ServerOpt(GlobalStep):
    """FedOpt servers (Reddi et al. 2021): Adam / momentum over the released
    pseudo-gradient, composable with any mechanism."""

    kind: str = "adam"
    lr: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    stateful = True

    def __post_init__(self):
        from repro_torch import optim
        if self.kind == "adam":
            opt = optim.adam(lr=self.lr, b1=self.beta1, b2=self.beta2, eps=self.eps)
        elif self.kind == "momentum":
            opt = optim.momentum(lr=self.lr, beta=self.beta1)
        else:
            raise ValueError(f"unknown ServerOpt kind {self.kind!r}")
        object.__setattr__(self, "_opt", opt)

    def init(self, w):
        """The optimizer's moments, on ``w``'s device."""
        return self._opt.init(w)

    def apply(self, noise, w, stats, extras, mechanism, clip, m_eff, state):
        """One optimizer step on the released mean."""
        step, state = self._opt.update(stats.cbar, state)
        return w + step, RoundAux(eta_g=torch.full((), self.lr, device=w.device)), state


@dataclasses.dataclass(frozen=True)
class AdaptiveClipStep(GlobalStep):
    """Quantile-tracked clipping (Andrew et al. 2021) over any mechanism.

    The clip threshold C lives in the carry as a 0-d tensor on the device,
    overrides the mechanism's static threshold each round (the kernel reads
    it there), and updates from the privatized below-threshold bit sum.  The
    step size is the mechanism's extrapolation read at the current C.
    """

    c0: float = 1.0
    gamma: float = 0.5
    clip_lr: float = 0.2
    sigma_b: float = 10.0

    stateful = True
    needs_clip_bits = True
    uses_extrapolation = True

    def draw(self, gen, mechanism):
        """xi when the mechanism needs it, then the bit-sum noise."""
        fields = _draw_xi(gen, mechanism)
        fields["bit"] = torch.randn((), generator=gen)
        return fields

    def clip_override(self, state):
        """The carried threshold."""
        return state.clip

    def init(self, w):
        """The tracker at c0, on ``w``'s device."""
        return ac.init_state(self.c0, w.device)

    def apply(self, noise, w, stats, extras, mechanism, clip, m_eff, state):
        """Extrapolate at the current C, then move C toward the gamma-quantile."""
        c = state.clip
        m_clients = extras.get("n_clients", m_eff)   # a weighted round's client count
        eta, _, _ = mechanism.extrapolation(noise, stats, extras, w.shape[-1], clip, m_clients)
        eta = eta.to(w.device)
        cfg = ac.AdaptiveClipConfig(gamma=self.gamma, lr=self.clip_lr, sigma_b=self.sigma_b)
        state, _ = ac.update_clip_from_stats(noise.bit, state, extras["count_below"],
                                             m_clients, cfg)
        return w + eta * stats.cbar, RoundAux(eta_g=eta, update_norm=c), state


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionCarry:
    """The server carry of an error-feedback compressed composition: the (d,)
    residual ``ef`` beside the step's own state ``inner``.  Checkpoints key
    them ``ef`` and ``inner/...``, as the JAX package's pytree."""

    ef: torch.Tensor
    inner: object


@dataclasses.dataclass(frozen=True)
class ComposedAlgorithm(ServerAlgorithm):
    """mechanism x aggregation x step as one ``ServerAlgorithm``.

    Unknown attributes forward to the layers (``alg.sigma`` ->
    ``mechanism.sigma``), as in the JAX package.
    """

    mechanism: PrivacyMechanism
    step: GlobalStep
    aggregation: Aggregation = MeanAggregation()
    name: str = "composed"

    def __post_init__(self):
        if self.aggregation.is_compressed and not self.mechanism.supports_compression:
            raise ValueError(
                f"{self.name!r} composes {type(self.mechanism).__name__} with "
                f"{type(self.aggregation).__name__}, but an LDP mechanism releases a full "
                "R^d vector per client: its noise is drawn before aggregation, so there is "
                "no sound compressed release.  Use CentralGaussian (noise is added to the "
                "compressed aggregate) or NoPrivacy, or drop the compression layer.")

    @property
    def supports_static_count(self):
        """False under weighted aggregation: the moment count is a weight sum."""
        return not self.aggregation.is_weighted

    @property
    def is_private(self):
        """Whether the composed release carries a DP guarantee (the mechanism's)."""
        return self.mechanism.is_private

    @property
    def needs_round_index(self):
        """True when the mechanism is a varying NoiseSchedule."""
        return self.mechanism.is_round_indexed

    def __getattr__(self, item):
        if item.startswith("__"):
            raise AttributeError(item)
        d = object.__getattribute__(self, "__dict__")
        for layer in ("mechanism", "step", "aggregation"):
            obj = d.get(layer)
            if obj is not None and hasattr(obj, item):
                return getattr(obj, item)
        raise AttributeError(
            f"{type(self).__name__} {d.get('name')!r} has no attribute {item!r}")

    def _mech_at(self, noise):
        """The mechanism releasing the round of the staged ``noise``: a
        round-indexed schedule's inner mechanism at the staged sigma(t), a 0-d
        tensor the release reads on the device; else the mechanism (a
        constant schedule's inner)."""
        if not self.needs_round_index:
            return self.mechanism.at_round(None)
        if noise is None or noise.sigma_t is None:
            raise ValueError(f"{self.name!r} carries a round-indexed noise schedule: its round's "
                             "noise must carry sigma(t) (stage_noise; pass the round index t)")
        return dataclasses.replace(self.mechanism.inner, sigma=noise.sigma_t)

    def comm_floats(self, d: int) -> int:
        """Floats one client uploads and the round reduces: the aggregation's
        vector (d, k, or width * depth), the three scalar moments, the
        mechanism's scalar sums, the clip-bit count of an adaptive clip and
        a weighted round's client count."""
        n = self.aggregation.comm_floats(d) + 3 + self.mechanism.n_scalar_extras
        n += int(self.step.needs_clip_bits) + int(self.aggregation.is_weighted)
        return n

    # -- compression ------------------------------------------------------------

    def _inner_state(self, state):
        """The step's own carry, out of an error-feedback ``CompressionCarry``."""
        return state.inner if isinstance(state, CompressionCarry) else state

    def _plan(self, noise):
        """The round's compression plan (``RoundNoise.plan``)."""
        if noise.plan is None:
            raise ValueError(f"{self.name!r} compresses each round under a plan; the "
                             "RoundNoise holds none (draw it with draw_noise)")
        return noise.plan

    def _compress_row_bound(self, clip):
        """The L2 bound compressed rows are re-clipped to: sens_factor C for a
        private mechanism whose compressor can grow a row (count-sketch);
        None when nothing binds."""
        if not self.mechanism.is_private or self.aggregation.sens_factor <= 1.0:
            return None
        return self.aggregation.sens_factor * self.mechanism._clip(clip)

    def init_state(self, w):
        """Initial carry for a run starting from ``w``: the step's, beside a
        zero residual under error feedback."""
        inner = self.step.init(w)
        if self.aggregation.uses_error_feedback:
            return CompressionCarry(ef=torch.zeros_like(w), inner=inner)
        return inner

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """Round ``t``'s randomness: the mechanism's draws, then the step's.  A
        compressed composition's central noise is (kc,) wide, and its plan
        comes from a generator of its own (``compression.plan_generator`` of
        ``gen``'s seed), which leaves ``gen``'s draws as they were."""
        mech_t = self.mechanism.at_round(self._round_index(t))
        fields = mech_t.draw(gen, m, self.aggregation.comm_floats(d), device)
        fields.update(self.step.draw(gen, mech_t))
        if self.aggregation.is_compressed:
            fields["plan"] = self.aggregation.plan(
                compression.plan_generator(gen.initial_seed()), d, device)
        return RoundNoise(**fields)

    def stage_noise(self, noise, device, t=None) -> RoundNoise:
        """``noise`` as the round's body reads it (``ServerAlgorithm``): a
        PrivUnit mechanism's quantiles, and a round-indexed schedule's
        sigma(t) (``sigma_at(t)``, float32), staged on ``device`` with the
        rest."""
        extra = {}
        if self.needs_round_index:
            extra["sigma_t"] = torch.tensor(self.mechanism.sigma_at(self._round_index(t)),
                                            dtype=torch.float32)
        if isinstance(self.mechanism, PrivUnitLDP):
            extra.update(self.mechanism.stage(noise))
        return stage_fields(noise, device, **extra)

    def _round_index(self, t):
        """``t``, which a round-indexed schedule needs."""
        if self.needs_round_index and t is None:
            raise ValueError(f"{self.name!r} carries a round-indexed noise schedule; pass "
                             "the round index t")
        return t

    def apply_round_stateful(self, gen, w, raw_deltas, state, noise=None, t=None):
        """Dense round ``t``: release the (M, d) raw deltas at the step's clip,
        then step.  A weighted composition takes the moment route with an
        all-ones mask, as the reference's does; a compressed one with no
        mask at all (full participation gates nothing)."""
        if noise is None:
            noise = self.stage_noise(self.draw_noise(gen, *raw_deltas.shape, raw_deltas.device, t),
                                     raw_deltas.device, t)
        mech_t = self._mech_at(noise)
        if self.aggregation.is_compressed:
            moments = self.local_moments(noise, w, raw_deltas, None, 0, state, t)
            return self.apply_from_moments(noise, w, moments, state, t)
        if self.aggregation.is_weighted:
            ones = torch.ones(raw_deltas.shape[0], device=raw_deltas.device)
            moments = self.local_moments(noise, w, raw_deltas, ones, 0, state, t,
                                         binary_mask=True)
            return self.apply_from_moments(noise, w, moments, state, t)
        clip = self.step.clip_override(state)
        m = float(raw_deltas.shape[0])
        stats, extras = mech_t.release(noise, raw_deltas, clip)
        if self.step.needs_clip_bits:
            norms = torch.linalg.vector_norm(raw_deltas, dim=-1)
            extras = {**extras, "count_below": torch.sum((norms <= clip).to(torch.float32))}
        return self.step.apply(noise, w, stats, extras, mech_t, clip, m, state)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *,
                      binary_mask=False):
        """A block's partial sums of round ``t``'s release (``ServerAlgorithm``):
        ``(RoundMoments, extras)``, extras holding the mechanism's scalar sums,
        the adaptive clip's ``count_below`` and a weighted round's
        ``n_clients``, all sums.  ``mask`` None is full participation; a
        compressed composition's ``sum_c`` is (kc,), under the round's plan."""
        clip = self.step.clip_override(self._inner_state(state))
        mech_t = self._mech_at(noise)
        weights = self.aggregation.row_weights(start, deltas.shape[0], deltas.device)
        kw = {}
        if self.aggregation.is_compressed:
            kw = dict(compress_fn=self.aggregation.compress_fn(self._plan(noise)),
                      compress_row_bound=self._compress_row_bound(clip))
        mom, extras = mech_t.moments(noise, deltas, mask, start, clip, weights,
                                     binary_mask=binary_mask, **kw)
        if self.step.needs_clip_bits:
            below = (torch.linalg.vector_norm(deltas, dim=-1) <= clip).to(torch.float32)
            extras = {**extras, "count_below": torch.sum(below) if mask is None else mask @ below}
        if self.aggregation.is_weighted:
            # mom.count is a weight sum; the clip update and the realized
            # cohort's noise read the client count
            n = (torch.full((), float(deltas.shape[0]), device=deltas.device) if mask is None
                 else torch.sum(mask))
            extras = {**extras, "n_clients": n}
        return mom, extras

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """The server update of round ``t`` from the cohort's moments."""
        mom, extras = moments
        clip = self.step.clip_override(self._inner_state(state))
        mech_t = self._mech_at(noise)
        m_eff = extras.get("n_clients", mom.count)
        if self.aggregation.is_compressed:
            return self._apply_compressed(noise, w, mom, extras, clip, m_eff, state, mech_t)
        stats, more = mech_t.finalize(noise, mom, extras, clip, m_eff)
        if more:
            extras = {**extras, **more}
        return self.step.apply(noise, w, stats, extras, mech_t, clip, mom.count, state)

    def _apply_compressed(self, noise, w, mom, extras, clip, m_eff, state, mech_t):
        """The compressed server update: noise in the compressed domain,
        decompress, error feedback, top-k, step.  The mechanism's dense
        ``finalize`` is bypassed: the scalar moments are the dense clipped
        values already, and ``agg_sq`` is the norm of the applied (d,)
        estimate."""
        d = w.shape[-1]
        plan = self._plan(noise)
        comp_mean = mom.sum_c / mom.count
        extra = mech_t.compressed_noise(noise, comp_mean.shape, clip, m_eff,
                                        self.aggregation.sens_factor)
        if extra is not None:
            comp_mean = comp_mean + extra
        g = self.aggregation.decompress(comp_mean, plan, d)
        ef_next = None
        if self.aggregation.uses_error_feedback:
            corrected = g + state.ef
            applied = self.aggregation.select(corrected)
            ef_next = corrected - applied
        else:
            applied = self.aggregation.select(g)
        stats = RoundStats(cbar=applied, mean_sq=mom.sum_sq / mom.count,
                           agg_sq=torch.sum(applied * applied),
                           mean_sq_clipped=mom.sum_sq_clipped / mom.count)
        w_next, aux, inner = self.step.apply(noise, w, stats, extras, mech_t, clip, mom.count,
                                             self._inner_state(state))
        if ef_next is not None:
            return w_next, aux, CompressionCarry(ef=ef_next, inner=inner)
        return w_next, aux, inner

    def budget(self, delta: float, *, rounds: int, dim: int,
               sampling_q: float = 1.0) -> accounting.PrivacyReport:
        """Privacy budget of a ``rounds``-round run: the mechanism's, told whether
        the step also releases the privatized FedEXP numerator."""
        if not self.mechanism.is_private:
            raise ValueError(f"{self.name!r} is not a private algorithm")
        if self.step.needs_clip_bits and not self.mechanism.clip_independent_budget:
            raise ValueError(
                f"{self.name!r} composes a fixed-noise mechanism with adaptive clipping: its "
                "per-round guarantee tracks the realized clip threshold and has no static "
                "budget.  Use CentralGaussian(z_mult=...) (noise tracks C) or PrivUnitLDP "
                "(pure-DP, C-independent) under AdaptiveClipStep.")
        with_num = self.step.uses_extrapolation and self.mechanism.needs_xi_key
        return self.mechanism.budget(delta, rounds=rounds, dim=dim, sampling_q=sampling_q,
                                     with_numerator=with_num)


def with_compression(alg: ComposedAlgorithm, aggregation: Aggregation) -> ComposedAlgorithm:
    """``alg`` with its aggregation layer swapped for ``aggregation`` and named
    ``<name>+<layer>`` (``+randk<k>``, ``+sketch<width>x<depth>[-top<k>][-ef]``).

    The mechanism and step stay as they were (clip, draws, budget); the
    composition is checked again, so an LDP mechanism is refused.  A
    weighted composition is refused (its weights would be dropped), and any
    algorithm that is not a ``ComposedAlgorithm`` (``dp-scaffold``) too."""
    if not isinstance(alg, ComposedAlgorithm):
        raise TypeError(
            f"with_compression needs a ComposedAlgorithm, got {type(alg).__name__}")
    if alg.aggregation.is_weighted:
        raise ValueError(
            f"{alg.name!r} uses weighted aggregation; replacing it with "
            f"{type(aggregation).__name__} would silently drop the per-client weights.  "
            "Compose a weighted-and-compressed layer explicitly if that is intended.")
    if isinstance(aggregation, RandKAggregation):
        tag = f"randk{aggregation.k}"
    elif isinstance(aggregation, CountSketchAggregation):
        tag = f"sketch{aggregation.width}x{aggregation.depth}"
        if aggregation.top_k is not None:
            tag += f"-top{aggregation.top_k}"
        if aggregation.error_feedback:
            tag += "-ef"
    else:
        tag = type(aggregation).__name__.lower()
    return dataclasses.replace(alg, aggregation=aggregation, name=f"{alg.name}+{tag}")


def compose_algorithm(mechanism: PrivacyMechanism, step: GlobalStep,
                      aggregation: Aggregation | None = None,
                      *, name: str | None = None) -> ComposedAlgorithm:
    """Build a ComposedAlgorithm with a derived name when none is given."""
    agg = MeanAggregation() if aggregation is None else aggregation
    if name is None:
        parts = [type(mechanism).__name__.lower(), type(step).__name__.lower()]
        if agg.is_weighted:
            parts.insert(1, "weighted")
        name = "-".join(parts)
    return ComposedAlgorithm(mechanism=mechanism, step=step, aggregation=agg, name=name)
