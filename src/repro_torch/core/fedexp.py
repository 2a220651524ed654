"""Federated server algorithms: DP-FedEXP and its baselines (counterpart of
repro/core/fedexp.py).

Two forms of the same algorithms:

* the registry (``make_algorithm``): every name a (mechanism, step)
  composition under the uniform ``MeanAggregation``, but
  ``ldp-fedexp-perclient``: a sigma per client from its own epsilon
  (``PerClientGaussian``) under the inverse-variance
  ``WeightedAggregation``, and ``dp-scaffold``: the control-variate server
  ``DPScaffoldServer``, run with ``LocalSpec(control_variates=True)``.  The
  port builds all 17 of the JAX registry's names.
* the ten monolithic classes of the JAX package, kept as the executable
  specification of the first ten names and as their direct-construction
  API: ``FedAvg``, ``FedEXP``, ``DPFedAvgLDPGaussian``,
  ``LDPFedEXPGaussian``, ``DPFedAvgPrivUnit``, ``LDPFedEXPPrivUnit``,
  ``DPFedAvgCDP``, ``CDPFedEXP``, ``CDPFedEXPAdaptiveClip`` and
  ``DPFedAdamCDP``.  Each is a frozen ``ServerAlgorithm`` written out on
  ``fused_clip_aggregate``, ``partial_clip_moments``, ``raw_moments``,
  ``stepsize``, ``adaptive_clip``, ``mechanisms`` and ``optim``, not on the
  compose layers, and computes what its registry name computes in the same
  float operations, so a session of one equals a session of the other in
  bits (``tests/test_torch_fedexp_legacy.py``).

The classes keep the port's round contract (``core/algorithm.py``): a round's
randomness is drawn by ``draw_noise`` from the round's CPU generator, in the
order the composed name draws it (the mechanism's fields, then the step's),
staged on the device by ``stage_noise``, and read by ``apply_round_stateful``
and the two moment halves, which read no host value (so the scan engine
replays them from a CUDA graph).  The JAX package splits one round key
where the port draws fields: CDP-FedEXP's ``k_noise, k_xi`` are
``RoundNoise.central`` and ``.xi``, the adaptive clip's ``k_bit`` is
``.bit``, drawn after them; the per-client LDP and PrivUnit draws are keyed
by (round seed, client), as ``algorithm.client_keys`` says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import accounting, stepsize
from repro_torch.core import adaptive_clip as ac
from repro_torch.core import compose as _compose
from repro_torch.core import mechanisms as mech
from repro_torch.core.aggregation import (
    RoundMoments,
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
    client_keys,
    device_normal,
    draw_seed32,
    rows_at,
    stage_fields,
)
from repro_torch.core.variance_reduction import DPScaffoldServer

__all__ = [
    "RoundAux",
    "ServerAlgorithm",
    "client_keys",
    "FedAvg",
    "FedEXP",
    "DPFedAvgLDPGaussian",
    "LDPFedEXPGaussian",
    "DPFedAvgPrivUnit",
    "LDPFedEXPPrivUnit",
    "DPFedAvgCDP",
    "CDPFedEXP",
    "CDPFedEXPAdaptiveClip",
    "DPFedAdamCDP",
    "make_algorithm",
    "list_algorithms",
]


def _unit_eta(w: torch.Tensor) -> torch.Tensor:
    """eta_g = 1 on ``w``'s device (DP-FedAvg's constant step)."""
    return torch.full((), 1.0, device=w.device)


class _Monolithic(ServerAlgorithm):
    """The dense round of a monolithic class: its round's noise drawn and
    staged when none is given, then ``_dense`` on it."""

    def apply_round_stateful(self, gen, w, raw_deltas, state, noise: RoundNoise | None = None,
                             t=None):
        """One dense round: ``-> (w_next, RoundAux, state)``."""
        if noise is None:
            noise = self.stage_noise(self.draw_noise(gen, *raw_deltas.shape, raw_deltas.device,
                                                     t), raw_deltas.device, t)
        return self._dense(noise, w, raw_deltas, state)


# ---------------------------------------------------------------------------
# Non-private references
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedAvg(_Monolithic):
    """Non-private FedAvg: ``w <- w + mean_i Delta_i`` (McMahan et al. 2017).

    The reductions are the kernel's none mode at C = inf (every scale 1), as
    the registry's ``NoPrivacy`` release reduces them."""

    name: str = "fedavg"
    is_private: bool = False

    def _stats(self, raw_deltas):
        return fused_clip_aggregate(raw_deltas, math.inf)

    def _dense(self, noise, w, raw_deltas, state):
        cbar = self._stats(raw_deltas).cbar
        aux = RoundAux(eta_g=_unit_eta(w), update_norm=torch.linalg.vector_norm(cbar))
        return w + cbar, aux, state

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The unclipped rows' sums under the mask (``raw_moments``)."""
        return raw_moments(deltas, mask, binary_mask=binary_mask)

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """w + the cohort's mean."""
        cbar = moments.sum_c / moments.count
        aux = RoundAux(eta_g=_unit_eta(w), update_norm=torch.linalg.vector_norm(cbar))
        return w + cbar, aux, state


@dataclasses.dataclass(frozen=True)
class FedEXP(FedAvg):
    """Non-private FedEXP: the adaptive extrapolated step size of Eq. (2)."""

    name: str = "fedexp"

    def _stepped(self, w, stats, state):
        eta = stepsize.fedexp(stats.mean_sq, stats.agg_sq).to(w.device)
        aux = RoundAux(eta_g=eta, update_norm=eta * torch.linalg.vector_norm(stats.cbar))
        return w + eta * stats.cbar, aux, state

    def _dense(self, noise, w, raw_deltas, state):
        return self._stepped(w, self._stats(raw_deltas), state)

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """Eq. (2) on the cohort's moments."""
        return self._stepped(w, moments.stats(), state)


# ---------------------------------------------------------------------------
# LDP: the Gaussian mechanism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPFedAvgLDPGaussian(_Monolithic):
    """DP-FedAvg under the Gaussian LDP randomizer: per-client clip + noise,
    eta_g = 1.

    Client r's noise at column j is keyed by (round seed, r, j): the fused
    ``dp_aggregate`` kernel draws it inside the release on the card, and a
    ``RoundNoise.ldp`` matrix replaces it.  ``local_moments`` takes the same
    seeded path (the kernel's fused mode with the mask as its row gate, the
    block's rows keyed by global client index), where the JAX class
    materializes the block's rows (``materialize_ldp_noise``) and adds them
    as an operand: the rows are the same, and the seeded path is the one
    whose bits the registry's ``GaussianLDP.moments`` gives."""

    clip_norm: float
    sigma: float
    name: str = "dp-fedavg-ldp-gauss"
    backend: str = "auto"

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """The round's 32-bit noise seed."""
        return RoundNoise(seed=draw_seed32(gen))

    def _release(self, noise, raw_deltas):
        if noise.ldp is not None:
            return fused_clip_aggregate(raw_deltas, self.clip_norm, noise.ldp,
                                        backend=self.backend)
        return fused_clip_aggregate(raw_deltas, self.clip_norm, noise_seed=noise.seed,
                                    noise_sigma=self.sigma, backend=self.backend)

    def _stepped(self, w, stats, state):
        return w + stats.cbar, RoundAux(eta_g=_unit_eta(w)), state

    def _dense(self, noise, w, raw_deltas, state):
        return self._stepped(w, self._release(noise, raw_deltas), state)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The masked release's sums; each row's noise is its client's."""
        m = deltas.shape[0]
        if noise.ldp is not None:
            return partial_clip_moments(deltas, self.clip_norm, rows_at(noise.ldp, start, m),
                                        weight_mask=mask, backend=self.backend)
        return partial_clip_moments(deltas, self.clip_norm, noise_seed=noise.seed,
                                    noise_sigma=self.sigma, start=start, weight_mask=mask,
                                    backend=self.backend)

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """The step on the cohort's moments."""
        return self._stepped(w, moments.stats(), state)

    def budget(self, delta, *, rounds, dim, sampling_q=1.0):
        """The per-release local guarantee (Prop. 4.1)."""
        return accounting.ldp_gaussian_budget(self.clip_norm, self.sigma, delta)


@dataclasses.dataclass(frozen=True)
class LDPFedEXPGaussian(DPFedAvgLDPGaussian):
    """Algorithm 1 with the bias-corrected step size, Eq. (6)."""

    name: str = "ldp-fedexp-gauss"

    def _stepped(self, w, stats, state):
        eta = stepsize.ldp_gaussian(stats.mean_sq, stats.agg_sq, w.shape[-1],
                                    self.sigma).to(w.device)
        aux = RoundAux(eta_g=eta,
                       eta_naive=stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                       eta_target=stepsize.target(stats.mean_sq_clipped, stats.agg_sq))
        return w + eta * stats.cbar, aux, state


# ---------------------------------------------------------------------------
# LDP: PrivUnit
# ---------------------------------------------------------------------------

_PRIVUNIT_ROWS = ("quantile", "round_u", "keep_u", "u_int")


@dataclasses.dataclass(frozen=True)
class DPFedAvgPrivUnit(_Monolithic):
    """DP-FedAvg under PrivUnit (direction) x ScalarDP (magnitude), eta_g = 1.

    Per client the round draws a cap and a quantile uniform, ScalarDP's
    rounding and keep uniforms and an integer in [0, k) on the host, and
    the 32-bit seed of the directions' N(0, 1) normal, whose row r is keyed
    by (seed, r) (the noise-only kernel on the card).  The stage turns the
    two uniforms into the (M,) quantiles, in float64 on the host."""

    clip_norm: float
    eps0: float
    eps1: float
    eps2: float
    dim: int
    name: str = "dp-fedavg-privunit"

    def __post_init__(self):
        object.__setattr__(self, "pu", mech.make_privunit_params(self.dim, self.eps0, self.eps1))
        object.__setattr__(self, "sc", mech.make_scalardp_params(self.eps2, self.clip_norm))

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """The per-client host draws, then the normal's seed."""
        fields = {f: torch.rand(m, generator=gen) for f in ("cap_u", "u01", "round_u", "keep_u")}
        fields["u_int"] = torch.randint(0, self.sc.k, (m,), generator=gen, dtype=torch.int32)
        fields["seed"] = draw_seed32(gen)
        return RoundNoise(**fields)

    def stage_noise(self, noise, device, t=None) -> RoundNoise:
        """The draws on ``device``, the quantiles in place of their uniforms."""
        q = mech.privunit_quantile(noise.cap_u, noise.u01, self.pu).to(torch.float32)
        return stage_fields(noise, device, quantile=q, cap_u=None, u01=None)

    def _randomize(self, noise, deltas, start=0):
        """Per-client clip + PrivUnit release of the block of clients at
        ``start``: (released, clipped) rows."""
        if noise.g is not None:
            g = rows_at(noise.g, start, deltas.shape[0])
        else:
            from repro_torch.kernels.dp_aggregate import ops
            g = ops.generate_ldp_noise(*deltas.shape, noise.seed, 1.0, device=deltas.device,
                                       **row_keys(start, deltas.device))
        norms = torch.linalg.vector_norm(deltas, dim=-1)
        clipped = deltas * torch.clamp(self.clip_norm / torch.clamp(norms, min=1e-12),
                                       max=1.0)[:, None]
        if noise.quantile is None:
            raise ValueError("PrivUnit releases the staged form of the round's noise, which "
                             "holds its quantiles (stage_noise)")
        released = mech.privunit_randomize(clipped, noise.quantile, g, noise.round_u,
                                           noise.keep_u, noise.u_int, self.pu, self.sc)
        return released, clipped

    def _release(self, noise, raw_deltas):
        """Dense release: (stats, mean_i s_hat_i)."""
        m = raw_deltas.shape[0]
        released, clipped = self._randomize(noise, raw_deltas)
        stats = aggregate_stats(released)
        stats.mean_sq_clipped = torch.sum(torch.sum(torch.square(clipped), dim=-1)) / m
        s_hat = mech.estimate_norm_sq(released, self.pu, self.sc)
        return stats, torch.sum(s_hat) / m

    def _released_moments(self, noise, deltas, mask, start):
        """The block's released rows and their sums: masked rows where-zeroed
        in the released and clipped sets, every other row weighted by its
        mask value; ``mask`` None sums as the dense release does."""
        m, n = deltas.shape[0], noise.round_u.shape[0]
        if not (isinstance(start, int) and start == 0 and n == m):
            # a streamed chunk's padding rows past M (mask 0) read client
            # M - 1's draws; their release is zeroed below
            idx = torch.clamp(global_client_indices(start, m, noise.round_u.device), max=n - 1)
            noise = dataclasses.replace(noise, **{f: getattr(noise, f)[idx]
                                                  for f in _PRIVUNIT_ROWS})
        released, clipped = self._randomize(noise, deltas, start)
        if mask is None:
            sq_clipped = torch.sum(torch.sum(torch.square(clipped), dim=-1))
            return released, RoundMoments(sum_c=released.sum(dim=0),
                                          sum_sq=torch.sum(released * released),
                                          sum_sq_clipped=sq_clipped, count=float(m))
        keep = (mask > 0)[:, None]
        released = torch.where(keep, released, 0.0)
        clipped = torch.where(keep, clipped, 0.0)
        return released, RoundMoments(sum_c=mask @ released,
                                      sum_sq=mask @ torch.sum(torch.square(released), dim=-1),
                                      sum_sq_clipped=mask @ torch.sum(torch.square(clipped),
                                                                      dim=-1),
                                      count=torch.sum(mask))

    def _dense(self, noise, w, raw_deltas, state):
        stats, _ = self._release(noise, raw_deltas)
        return w + stats.cbar, RoundAux(eta_g=_unit_eta(w)), state

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The masked release's sums over the block's clients, each randomized
        with its own draws."""
        return self._released_moments(noise, deltas, mask, start)[1]

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """w + the cohort's released mean."""
        return w + moments.sum_c / moments.count, RoundAux(eta_g=_unit_eta(w)), state

    def budget(self, delta, *, rounds, dim, sampling_q=1.0):
        """Lemma B.1: pure (eps0 + eps1 + eps2)-LDP per release."""
        return accounting.privunit_budget(self.eps0, self.eps1, self.eps2)


@dataclasses.dataclass(frozen=True)
class LDPFedEXPPrivUnit(DPFedAvgPrivUnit):
    """Algorithm 1 with the PrivUnit norm-estimation step size, Eq. (7)."""

    name: str = "ldp-fedexp-privunit"

    def _stepped(self, w, stats, mean_s_hat, state):
        eta = stepsize.ldp_privunit(mean_s_hat, stats.agg_sq).to(w.device)
        aux = RoundAux(eta_g=eta,
                       eta_naive=stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                       eta_target=stepsize.target(stats.mean_sq_clipped, stats.agg_sq))
        return w + eta * stats.cbar, aux, state

    def _dense(self, noise, w, raw_deltas, state):
        return self._stepped(w, *self._release(noise, raw_deltas), state)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The masked release's sums and the sum of its Algorithm-4 estimates."""
        released, mom = self._released_moments(noise, deltas, mask, start)
        s_hat = mech.estimate_norm_sq(released, self.pu, self.sc)
        return mom, {"sum_s_hat": torch.sum(s_hat) if mask is None else mask @ s_hat}

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """Eq. (7) on the cohort's moments."""
        mom, extras = moments
        return self._stepped(w, mom.stats(), extras["sum_s_hat"] / mom.count, state)


# ---------------------------------------------------------------------------
# CDP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPFedAvgCDP(_Monolithic):
    """DP-FedAvg under central DP: clip-only clients + server noise on the mean.

    The clients' release is the kernel's none mode; the server adds
    ``sigma / sqrt(M) * RoundNoise.central`` (a (d,) N(0, 1) drawn on the
    device) to the mean, with the configured M."""

    clip_norm: float
    sigma: float           # the paper's sigma; the server noise std is sigma / sqrt(M)
    num_clients: int
    name: str = "dp-fedavg-cdp"
    backend: str = "auto"

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """N(0, 1) of the (d,) mean, drawn on the device."""
        return RoundNoise(central=device_normal(gen, (d,), device))

    def _noised_cbar(self, noise, cbar):
        return cbar + (self.sigma / math.sqrt(float(self.num_clients))) * noise.central

    def _release(self, noise, raw_deltas):
        """(clipped statistics, noised mean)."""
        stats = fused_clip_aggregate(raw_deltas, self.clip_norm, None, backend=self.backend)
        return stats, self._noised_cbar(noise, stats.cbar)

    def _stepped(self, noise, w, cbar, mean_sq_clipped, state):
        return w + cbar, RoundAux(eta_g=_unit_eta(w)), state

    def _dense(self, noise, w, raw_deltas, state):
        stats, cbar = self._release(noise, raw_deltas)
        return self._stepped(noise, w, cbar, stats.mean_sq_clipped, state)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The clipped rows' sums (none mode); the noise comes on the server."""
        return partial_clip_moments(deltas, self.clip_norm, None, weight_mask=mask,
                                    backend=self.backend)

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """Noise the cohort's mean, then step."""
        cbar = self._noised_cbar(noise, moments.sum_c / moments.count)
        return self._stepped(noise, w, cbar, moments.sum_sq_clipped / moments.count, state)

    def budget(self, delta, *, rounds, dim, sampling_q=1.0):
        """The composed GDP budget of the noised means (Prop. 4.2)."""
        return accounting.cdp_budget(self.clip_norm, self.sigma, self.num_clients, rounds,
                                     delta, sampling_q=sampling_q)


@dataclasses.dataclass(frozen=True)
class CDPFedEXP(DPFedAvgCDP):
    """Algorithm 2 with the privatized-numerator step size, Eq. (8).

    sigma_xi defaults to the hyperparameter-free d * sigma^2 / M (Section 3.2);
    the numerator's N(0, 1) is ``RoundNoise.xi``, drawn after the mean's."""

    sigma_xi: float | None = None
    name: str = "cdp-fedexp"

    def _sigma_xi(self, dim: int) -> float:
        if self.sigma_xi is not None:
            return self.sigma_xi
        return dim * self.sigma**2 / self.num_clients

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """The mean's N(0, 1) on the device, then the numerator's on the host."""
        noise = super().draw_noise(gen, m, d, device, t)
        noise.xi = torch.randn((), generator=gen)
        return noise

    def _stepped(self, noise, w, cbar, mean_sq_clipped, state):
        agg_sq = torch.sum(cbar * cbar)
        xi = self._sigma_xi(w.shape[-1]) * noise.xi
        eta = stepsize.cdp(mean_sq_clipped, xi, agg_sq).to(w.device)
        aux = RoundAux(eta_g=eta, eta_target=stepsize.target(mean_sq_clipped, agg_sq))
        return w + eta * cbar, aux, state

    def budget(self, delta, *, rounds, dim, sampling_q=1.0):
        """The composed GDP budget of the noised means and numerators."""
        return accounting.cdp_budget(self.clip_norm, self.sigma, self.num_clients, rounds,
                                     delta, sigma_xi=self._sigma_xi(dim), sampling_q=sampling_q)


# ---------------------------------------------------------------------------
# Adaptive clipping (Andrew et al. 2021) x CDP-FedEXP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CDPFedEXPAdaptiveClip(_Monolithic):
    """CDP-FedEXP with a quantile-tracked clipping threshold.

    Per round: clip at the current C, release the mean with noise std
    ``z C / sqrt(m)`` (a fixed noise multiplier z, so the guarantee does not
    depend on C; m the realized cohort), pick eta by Eq. (8) with sigma_xi =
    d (z C)^2 / m, and move C toward the gamma-quantile of the update norms
    from the privatized below-threshold count.  C is a 0-d float32 tensor on
    the device (``adaptive_clip.AdaptiveClipState``): the kernel reads it
    there, and no step reads it on the host.  The round draws the mean's
    N(0, 1), the numerator's and then the bit sum's."""

    z_mult: float               # noise multiplier; per-round std = z C / sqrt(m)
    num_clients: int
    dim: int
    c0: float = 1.0
    gamma: float = 0.5
    clip_lr: float = 0.2
    sigma_b: float = 10.0
    name: str = "cdp-fedexp-adaptive-clip"
    backend: str = "auto"

    def init_state(self, w):
        """The tracker at c0, on ``w``'s device."""
        return ac.init_state(self.c0, w.device)

    def draw_noise(self, gen, m, d, device, t=None) -> RoundNoise:
        """The mean's N(0, 1) on the device, the numerator's and the bit
        sum's on the host."""
        central = device_normal(gen, (d,), device)
        xi = torch.randn((), generator=gen)
        return RoundNoise(central=central, xi=xi, bit=torch.randn((), generator=gen))

    def _serve(self, noise, w, cbar_mean, mean_sq_clipped, count_below, m, state):
        """The server half: noise the mean, pick eta, track the clip.  ``m``
        is the cohort's count (a host float, or a tensor on the device,
        floored at 1 where it divides the noise)."""
        d = w.shape[-1]
        c = state.clip
        sigma = self.z_mult * c                 # the paper's sigma, tracking C
        m_noise = torch.clamp(m, min=1.0) if isinstance(m, torch.Tensor) else m
        root = torch.sqrt(m_noise) if isinstance(m_noise, torch.Tensor) else math.sqrt(m_noise)
        cbar = cbar_mean + (sigma / root) * noise.central
        agg_sq = torch.sum(cbar * cbar)
        xi = (d * sigma**2 / m_noise) * noise.xi
        eta = stepsize.cdp(mean_sq_clipped, xi, agg_sq).to(w.device)
        cfg = ac.AdaptiveClipConfig(gamma=self.gamma, lr=self.clip_lr, sigma_b=self.sigma_b)
        state, _ = ac.update_clip_from_stats(noise.bit, state, count_below, m, cfg)
        return w + eta * cbar, RoundAux(eta_g=eta, update_norm=c), state   # the clip used

    def _dense(self, noise, w, raw_deltas, state):
        stats = fused_clip_aggregate(raw_deltas, state.clip, None, backend=self.backend)
        norms = torch.linalg.vector_norm(raw_deltas, dim=-1)
        count_below = torch.sum((norms <= state.clip).to(torch.float32))
        return self._serve(noise, w, stats.cbar, stats.mean_sq_clipped, count_below,
                           float(raw_deltas.shape[0]), state)

    def local_moments(self, noise, w, deltas, mask, start, state, t=None, *, binary_mask=False):
        """The clipped rows' sums at the current C, and the below-C count."""
        mom = partial_clip_moments(deltas, state.clip, None, weight_mask=mask,
                                   backend=self.backend)
        below = (torch.linalg.vector_norm(deltas, dim=-1) <= state.clip).to(torch.float32)
        return mom, {"count_below": torch.sum(below) if mask is None else mask @ below}

    def apply_from_moments(self, noise, w, moments, state, t=None):
        """The server half on the cohort's moments."""
        mom, extras = moments
        return self._serve(noise, w, mom.sum_c / mom.count, mom.sum_sq_clipped / mom.count,
                           extras["count_below"], mom.count, state)

    def apply_round(self, gen, w, raw_deltas, noise=None, t=None):
        """Refused: the clip threshold is carried from round to round."""
        raise TypeError("stateful algorithm; use apply_round_stateful")

    def budget(self, delta, *, rounds, dim, sampling_q=1.0):
        """The z-tracking CDP budget: C cancels from the C / sigma ratio, and
        the realized cohort's count is M / q (the clip-bit release adds
        ``adaptive_clip_rho``, negligible at sigma_b ~ 10)."""
        return _compose.CentralGaussian(z_mult=self.z_mult, num_clients=self.num_clients).budget(
            delta, rounds=rounds, dim=dim, sampling_q=sampling_q, with_numerator=True)


# ---------------------------------------------------------------------------
# FedOpt (Reddi et al., 2021): the server the paper argues against
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DPFedAdamCDP(DPFedAvgCDP):
    """DP-FedAdam: server Adam over the privatized pseudo-gradient.

    The release is DP-FedAvg's (CDP); the server applies Adam with a global
    learning rate ``server_lr``, the extra hyperparameter whose DP-safe
    tuning the paper names as the practical blocker.  The carry is
    ``repro_torch.optim.adam``'s ``(m, v, t)``, as the registry's
    ``dp-fedadam-cdp`` carries it, so checkpoints and ``resume`` treat both
    alike."""

    server_lr: float = 0.1
    name: str = "dp-fedadam-cdp"

    def __post_init__(self):
        from repro_torch import optim
        object.__setattr__(self, "_opt", optim.adam(lr=self.server_lr))

    def init_state(self, w):
        """Adam's moments and step count, on ``w``'s device."""
        return self._opt.init(w)

    def _stepped(self, noise, w, cbar, mean_sq_clipped, state):
        step, state = self._opt.update(cbar, state)
        return w + step, RoundAux(eta_g=torch.full((), self.server_lr, device=w.device)), state

    def apply_round(self, gen, w, raw_deltas, noise=None, t=None):
        """Refused: Adam's moments are carried from round to round."""
        raise TypeError("DPFedAdamCDP is stateful; use apply_round_stateful")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _backend(kw) -> str:
    return kw.get("backend", "auto")


def _gauss_ldp(kw) -> _compose.GaussianLDP:
    return _compose.GaussianLDP(kw["clip_norm"], kw["sigma"], backend=_backend(kw))


def _privunit(kw) -> _compose.PrivUnitLDP:
    return _compose.PrivUnitLDP(kw["clip_norm"], kw["eps0"], kw["eps1"], kw["eps2"], kw["dim"])


def _cdp(kw) -> _compose.CentralGaussian:
    return _compose.CentralGaussian(clip_norm=kw["clip_norm"], sigma=kw["sigma"],
                                    num_clients=kw["num_clients"],
                                    sigma_xi=kw.get("sigma_xi"), backend=_backend(kw))


def _adaptive_cdp(kw) -> _compose.CentralGaussian:
    return _compose.CentralGaussian(z_mult=kw["z_mult"], num_clients=kw["num_clients"],
                                    backend=_backend(kw))


def _adaptive_step(kw) -> _compose.AdaptiveClipStep:
    return _compose.AdaptiveClipStep(c0=kw.get("c0", 1.0), gamma=kw.get("gamma", 0.5),
                                     clip_lr=kw.get("clip_lr", 0.2),
                                     sigma_b=kw.get("sigma_b", 10.0))


def _schedule(inner, kw) -> _compose.NoiseSchedule:
    return _compose.NoiseSchedule(inner=inner, decay=kw.get("decay", 1.0),
                                  boundaries=tuple(kw.get("boundaries", ())),
                                  scales=tuple(kw.get("scales", ())))


def _adam(kw) -> _compose.ServerOpt:
    return _compose.ServerOpt(kind="adam", lr=kw.get("server_lr", 0.1))


def _composed(name: str, mechanism, step) -> _compose.ComposedAlgorithm:
    return _compose.ComposedAlgorithm(mechanism=mechanism, step=step, name=name)


def _perclient_weighted(kw) -> _compose.ComposedAlgorithm:
    # per-client sigmas from the public epsilons, aggregated with the
    # matching public inverse-variance weights
    mechanism = _compose.PerClientGaussian(kw["clip_norm"], tuple(kw["epsilons"]), kw["delta"],
                                           backend=_backend(kw))
    return _compose.ComposedAlgorithm(
        mechanism=mechanism, step=_compose.FedEXPStep(),
        aggregation=_compose.WeightedAggregation(mechanism.inverse_variance_weights()),
        name="ldp-fedexp-perclient")


def _scaffold(kw) -> DPScaffoldServer:
    return DPScaffoldServer(clip_norm=kw["clip_norm"], sigma=kw["sigma"], central=kw["central"],
                            num_clients=kw["num_clients"], tau=kw["tau"], eta_l=kw["eta_l"],
                            backend=_backend(kw))


_FACTORIES: dict[str, Callable[..., ServerAlgorithm]] = {
    "fedavg": lambda **kw: _composed(
        "fedavg", _compose.NoPrivacy(), _compose.FixedEta()),
    "fedexp": lambda **kw: _composed(
        "fedexp", _compose.NoPrivacy(), _compose.FedEXPStep()),
    "dp-fedavg-ldp-gauss": lambda **kw: _composed(
        "dp-fedavg-ldp-gauss", _gauss_ldp(kw), _compose.FixedEta()),
    "ldp-fedexp-gauss": lambda **kw: _composed(
        "ldp-fedexp-gauss", _gauss_ldp(kw), _compose.FedEXPStep()),
    "dp-fedavg-privunit": lambda **kw: _composed(
        "dp-fedavg-privunit", _privunit(kw), _compose.FixedEta()),
    "ldp-fedexp-privunit": lambda **kw: _composed(
        "ldp-fedexp-privunit", _privunit(kw), _compose.FedEXPStep()),
    "dp-fedavg-cdp": lambda **kw: _composed(
        "dp-fedavg-cdp", _cdp(kw), _compose.FixedEta()),
    "cdp-fedexp": lambda **kw: _composed(
        "cdp-fedexp", _cdp(kw), _compose.FedEXPStep()),
    "dp-fedadam-cdp": lambda **kw: _composed(
        "dp-fedadam-cdp", _cdp(kw), _adam(kw)),
    "cdp-fedexp-adaptive-clip": lambda **kw: _composed(
        "cdp-fedexp-adaptive-clip", _adaptive_cdp(kw), _adaptive_step(kw)),
    "ldp-gauss-fedadam": lambda **kw: _composed(
        "ldp-gauss-fedadam", _gauss_ldp(kw), _adam(kw)),
    "cdp-fedmom": lambda **kw: _composed(
        "cdp-fedmom", _cdp(kw),
        _compose.ServerOpt(kind="momentum", lr=kw.get("server_lr", 1.0),
                           beta1=kw.get("server_beta", 0.9))),
    "privunit-fedexp-adaptive-clip": lambda **kw: _composed(
        "privunit-fedexp-adaptive-clip",
        _privunit({**kw, "clip_norm": kw.get("clip_norm", kw.get("c0", 1.0))}),
        _adaptive_step(kw)),
    "ldp-fedexp-schedule": lambda **kw: _composed(
        "ldp-fedexp-schedule", _schedule(_gauss_ldp(kw), kw), _compose.FedEXPStep()),
    "cdp-fedexp-schedule": lambda **kw: _composed(
        "cdp-fedexp-schedule", _schedule(_cdp(kw), kw), _compose.FedEXPStep()),
    "ldp-fedexp-perclient": lambda **kw: _perclient_weighted(kw),
    "dp-scaffold": lambda **kw: _scaffold(kw),
}


def list_algorithms() -> list[str]:
    """Sorted names of every server algorithm the port runs."""
    return sorted(_FACTORIES)


def make_algorithm(name: str, **kwargs) -> ServerAlgorithm:
    """Build a registered server algorithm by name.

    Args:
      name: one of ``list_algorithms()``.
      **kwargs: the composition's knobs, as the JAX registry's:
        ``clip_norm`` and ``sigma`` for the Gaussian names, plus
        ``num_clients`` (and optionally ``sigma_xi``) for CDP;
        ``eps0``/``eps1``/``eps2``/``dim`` for PrivUnit; ``z_mult``,
        ``num_clients`` and ``c0``/``gamma``/``clip_lr``/``sigma_b`` for
        adaptive clipping; ``server_lr`` (and ``server_beta`` for momentum)
        for the server optimizers; ``decay``/``boundaries``/``scales`` for
        the schedules; ``epsilons`` (one per client) and ``delta`` with
        ``clip_norm`` for ``ldp-fedexp-perclient``; ``clip_norm``,
        ``sigma``, ``central``, ``num_clients``, ``tau`` and ``eta_l`` for
        ``dp-scaffold`` (the server mirrors the local phase); ``backend``
        ("auto" | "kernel" | "kernel-fused" | "torch") for the Gaussian names
        and ``dp-scaffold``.
    """
    if name not in _FACTORIES:
        raise KeyError(f"unknown algorithm {name!r}; valid names: "
                       f"{', '.join(list_algorithms())}")
    return _FACTORIES[name](**kwargs)
