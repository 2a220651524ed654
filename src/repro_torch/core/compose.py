"""Composable algorithm stack: privacy mechanism x aggregation x global step.

Counterpart of repro/core/compose.py, holding what the dense round of the
paper's six Gaussian and noiseless algorithms needs:

    PrivacyMechanism   clipping + noise + the step-size bias correction + the
                       accounting of its release: ``NoPrivacy``,
                       ``GaussianLDP``, ``CentralGaussian`` (fixed sigma).
    Aggregation        ``MeanAggregation``, the paper's uniform mean.
    GlobalStep         ``FixedEta`` (DP-FedAvg) and ``FedEXPStep`` (the
                       paper's adaptive extrapolation, Eqs. 2/6/8).

Every release reduces through ``fused_clip_aggregate``: on the card that is
the CUDA ``dp_aggregate`` kernel (fused noise for ``GaussianLDP``, none mode
for ``CentralGaussian`` and, with C = inf, for ``NoPrivacy``).

Randomness (``repro_torch.core.algorithm``): ``draw`` methods take what the
round consumes from its generator, mechanism first, then step; ``release``
and ``apply`` only read the resulting ``RoundNoise``.

PrivUnit, per-client and scheduled noise, weighted and compressed
aggregation, server optimizers and adaptive clipping come in later slices
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import accounting, stepsize
from repro_torch.core.aggregation import RoundStats, fused_clip_aggregate
from repro_torch.core.algorithm import (
    RoundAux,
    RoundNoise,
    ServerAlgorithm,
    device_normal,
    draw_seed32,
)

__all__ = [
    "PrivacyMechanism",
    "NoPrivacy",
    "GaussianLDP",
    "CentralGaussian",
    "Aggregation",
    "MeanAggregation",
    "GlobalStep",
    "FixedEta",
    "FedEXPStep",
    "ComposedAlgorithm",
    "compose_algorithm",
]


# ---------------------------------------------------------------------------
# Privacy mechanisms
# ---------------------------------------------------------------------------

class PrivacyMechanism:
    """One client randomizer + its clipping regime + its accounting.

        draw(gen, m, d, device)                 -> RoundNoise fields it consumes
        release(noise, deltas)                  dense (M, d) -> RoundStats
        extrapolation(noise, stats, dim)        -> (eta_g, eta_naive, eta_target)
        budget(delta, rounds, dim, sampling_q, with_numerator) -> PrivacyReport
    """

    is_private = True
    needs_xi_key = False            # CDP-style post-aggregation numerator noise

    def draw(self, gen: torch.Generator, m: int, d: int, device) -> dict:
        """The ``RoundNoise`` fields this release consumes, drawn from ``gen``."""
        return {}

    def release(self, noise: RoundNoise, deltas: torch.Tensor):
        """Dense release: clip + randomize + reduce M rows to ``RoundStats``."""
        raise NotImplementedError

    def extrapolation(self, noise: RoundNoise, stats: RoundStats, dim: int):
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

    def release(self, noise, deltas):
        """Dense release: the three reductions of the unclipped rows."""
        s = fused_clip_aggregate(deltas, math.inf)
        return RoundStats(cbar=s.cbar, mean_sq=s.mean_sq, agg_sq=s.agg_sq)

    def extrapolation(self, noise, stats, dim):
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

    def release(self, noise, deltas):
        """Dense release: clip, add sigma * N(0, 1) per client, reduce."""
        if noise.ldp is not None:
            return fused_clip_aggregate(deltas, self.clip_norm, noise.ldp,
                                        backend=self.backend)
        return fused_clip_aggregate(deltas, self.clip_norm, noise_seed=noise.seed,
                                    noise_sigma=self.sigma, backend=self.backend)

    def extrapolation(self, noise, stats, dim):
        """Eq. (6), with the naive (Eq. 3) and target (Eq. 5) diagnostics."""
        eta = stepsize.ldp_gaussian(stats.mean_sq, stats.agg_sq, dim, self.sigma)
        return (eta,
                stepsize.naive_noisy(stats.mean_sq, stats.agg_sq),
                stepsize.target(stats.mean_sq_clipped, stats.agg_sq))

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Per-release local guarantee (Prop. 4.1), whatever the step."""
        return accounting.ldp_gaussian_budget(self.clip_norm, self.sigma, delta)


@dataclasses.dataclass(frozen=True)
class CentralGaussian(PrivacyMechanism):
    """Clip-only clients + server-side Gaussian noise on the mean (CDP).

    Fixed ``sigma`` (the paper): server noise std ``sigma / sqrt(M)`` with the
    static configured client count — the release Proposition 4.2 accounts.
    The adaptive ``z_mult`` mode comes with adaptive clipping.
    """

    clip_norm: float | None = None
    sigma: float | None = None
    num_clients: int = 0
    sigma_xi: float | None = None     # numerator noise; None = d sigma^2 / M
    backend: str = "auto"

    needs_xi_key = True

    def __post_init__(self):
        if self.sigma is None or self.clip_norm is None:
            raise ValueError("CentralGaussian needs clip_norm and a fixed sigma "
                             "(the z_mult mode comes with adaptive clipping)")
        if self.num_clients < 1:
            raise ValueError("CentralGaussian requires num_clients >= 1")

    def draw(self, gen, m, d, device):
        """N(0, 1) of the (d,) mean, drawn on the device."""
        return {"central": device_normal(gen, (d,), device)}

    def release(self, noise, deltas):
        """Dense release: clip, reduce, then noise the mean."""
        stats = fused_clip_aggregate(deltas, self.clip_norm, None, backend=self.backend)
        cbar = stats.cbar + (self.sigma / math.sqrt(self.num_clients)) * noise.central
        return RoundStats(cbar=cbar, mean_sq=stats.mean_sq, agg_sq=torch.sum(cbar * cbar),
                          mean_sq_clipped=stats.mean_sq_clipped)

    def extrapolation(self, noise, stats, dim):
        """Eq. (8): the clipped numerator plus sigma_xi * xi, and the target."""
        sigma_xi = (self.sigma_xi if self.sigma_xi is not None
                    else dim * self.sigma**2 / self.num_clients)
        xi = sigma_xi * noise.xi
        eta = stepsize.cdp(stats.mean_sq_clipped, xi, stats.agg_sq)
        return eta, None, stepsize.target(stats.mean_sq_clipped, stats.agg_sq)

    def budget(self, delta, *, rounds, dim, sampling_q, with_numerator):
        """Composed GDP budget of the noised mean (and numerator, with FedEXP)."""
        sigma_xi = None
        if with_numerator:
            sigma_xi = (self.sigma_xi if self.sigma_xi is not None
                        else dim * self.sigma**2 / self.num_clients)
        return accounting.cdp_budget(self.clip_norm, self.sigma, self.num_clients, rounds,
                                     delta, sigma_xi=sigma_xi, sampling_q=sampling_q)


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

class Aggregation:
    """How released client updates combine into the round's moments."""


@dataclasses.dataclass(frozen=True)
class MeanAggregation(Aggregation):
    """Uniform mean over the cohort — the paper's aggregation."""


# ---------------------------------------------------------------------------
# Global steps
# ---------------------------------------------------------------------------

class GlobalStep:
    """Server-side update policy + owner of the carry state and its extra draws."""

    uses_extrapolation = False

    def draw(self, gen: torch.Generator, mechanism: PrivacyMechanism) -> dict:
        """The ``RoundNoise`` fields this step consumes, drawn after the mechanism's."""
        return {}

    def init(self, w):
        """Initial step-owned carry state."""
        return ()

    def apply(self, noise, w, stats, mechanism, state):
        """``-> (w_next, RoundAux, state)`` from the released round statistics."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedEta(GlobalStep):
    """w <- w + eta_g * cbar with a constant eta_g (DP-FedAvg: eta_g = 1)."""

    eta: float = 1.0

    def apply(self, noise, w, stats, mechanism, state):
        """Apply the constant step."""
        w_next = w + stats.cbar if self.eta == 1.0 else w + self.eta * stats.cbar
        return w_next, RoundAux(eta_g=torch.tensor(self.eta, device=w.device)), state


@dataclasses.dataclass(frozen=True)
class FedEXPStep(GlobalStep):
    """The paper's adaptive extrapolation (Eqs. 2/6/8): the mechanism supplies
    its debiased numerator; this step extrapolates by the ratio, floored at 1."""

    uses_extrapolation = True

    def draw(self, gen, mechanism):
        """xi ~ N(0, 1) when the mechanism privatizes the numerator."""
        if not mechanism.needs_xi_key:
            return {}
        return {"xi": torch.randn((), generator=gen)}

    def apply(self, noise, w, stats, mechanism, state):
        """Extrapolate: w + eta_g * cbar."""
        eta, naive, target = mechanism.extrapolation(noise, stats, w.shape[-1])
        eta = eta.to(w.device)
        aux = RoundAux(eta_g=eta, eta_naive=naive, eta_target=target,
                       update_norm=eta * torch.linalg.vector_norm(stats.cbar))
        return w + eta * stats.cbar, aux, state


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

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
        if not isinstance(self.aggregation, MeanAggregation):
            raise NotImplementedError(
                f"{type(self.aggregation).__name__} is not ported yet: weighted and "
                "compressed aggregation come in later slices (ROADMAP.md, queue 1)")

    @property
    def is_private(self):
        """Whether the composed release carries a DP guarantee (the mechanism's)."""
        return self.mechanism.is_private

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

    def init_state(self, w):
        """Initial carry for a run starting from ``w`` (the step's)."""
        return self.step.init(w)

    def draw_noise(self, gen, m, d, device) -> RoundNoise:
        """The round's randomness: the mechanism's draws, then the step's."""
        fields = self.mechanism.draw(gen, m, d, device)
        fields.update(self.step.draw(gen, self.mechanism))
        return RoundNoise(**fields)

    def apply_round_stateful(self, gen, w, raw_deltas, state, noise=None):
        """Dense round: release the (M, d) raw deltas, then step."""
        if noise is None:
            noise = self.draw_noise(gen, *raw_deltas.shape, raw_deltas.device)
        stats = self.mechanism.release(noise, raw_deltas)
        return self.step.apply(noise, w, stats, self.mechanism, state)

    def budget(self, delta: float, *, rounds: int, dim: int,
               sampling_q: float = 1.0) -> accounting.PrivacyReport:
        """Privacy budget of a ``rounds``-round run: the mechanism's, told whether
        the step also releases the privatized FedEXP numerator."""
        if not self.mechanism.is_private:
            raise ValueError(f"{self.name!r} is not a private algorithm")
        with_num = self.step.uses_extrapolation and self.mechanism.needs_xi_key
        return self.mechanism.budget(delta, rounds=rounds, dim=dim, sampling_q=sampling_q,
                                     with_numerator=with_num)


def compose_algorithm(mechanism: PrivacyMechanism, step: GlobalStep,
                      aggregation: Aggregation | None = None,
                      *, name: str | None = None) -> ComposedAlgorithm:
    """Build a ComposedAlgorithm with a derived name when none is given."""
    agg = MeanAggregation() if aggregation is None else aggregation
    if name is None:
        name = "-".join([type(mechanism).__name__.lower(), type(step).__name__.lower()])
    return ComposedAlgorithm(mechanism=mechanism, step=step, aggregation=agg, name=name)
