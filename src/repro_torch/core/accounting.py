"""Privacy accounting for DP-FedEXP (Propositions 4.1 / 4.2 + tight numerics).

A copy of repro/core/accounting.py, kept in step with it by
tests/test_torch_core.py: the port imports nothing of the JAX package.

Three accountants:

1. **RDP** (Mironov 2017) — the paper's stated guarantees:
   Gaussian with sensitivity ``s`` and noise std ``sigma`` is
   (alpha, alpha * s^2 / (2 sigma^2))-RDP; composition adds; conversion via
   Lemma C.2: eps = eps_rdp + log(1/delta)/(alpha - 1), minimized over alpha.

2. **GDP / analytic Gaussian ("numerical composition")** — the paper audits
   with Gopi et al.'s numerical composition.  For compositions of *Gaussian*
   mechanisms the privacy-loss distribution is exactly Gaussian, so numerical
   composition reduces to f-DP algebra: each mechanism contributes
   mu_j = s_j / sigma_j and the T-fold composition has
   mu_tot = sqrt(sum_j T_j mu_j^2).  The exact (eps, delta) curve is the
   Balle & Wang (2018) analytic formula
        delta(eps) = Phi(mu/2 - eps/mu) - e^eps * Phi(-mu/2 - eps/mu),
   inverted for eps by bisection.  This is tight (it *is* the numerical
   composition answer, computed in closed form).

3. **Pure DP** for PrivUnit: eps = eps0 + eps1 + eps2 (Lemma B.1).

All math is float64 Python (no jax) — accounting is config-time.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "gaussian_rdp_epsilon",
    "gdp_epsilon",
    "gdp_delta",
    "gdp_mu_for_epsilon",
    "sigma_for_epsilon",
    "subsampled_gdp_mu",
    "composed_gdp_mu",
    "realized_participation",
    "ldp_gaussian_budget",
    "cdp_budget",
    "schedule_ldp_budget",
    "schedule_cdp_budget",
    "privunit_budget",
    "PrivacyReport",
]


def realized_participation(sampling_q: float, dropout: float = 0.0) -> float:
    """Per-round participation rate the accountant should compose with.

    Under the §13 fault model a sampled client DROPS OUT independently with
    probability ``dropout`` before contributing, so the realized per-round
    participation is q * (1 - dropout) — a client's data enters round t's
    release only if it is both sampled AND alive, two independent Bernoulli
    events.  Budgets must compose against this realized rate, not the
    nominal q: the dropped clients' updates never touch the release, so
    amplification-by-subsampling applies at the realized rate (and the
    conditional-sensitivity inflation of ``cdp_budget`` inflates by the same
    realized rate — accounting stays honest in both directions).
    """
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    return sampling_q * (1.0 - dropout)


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _log_phi(x: float) -> float:
    """log Phi(x), stable for very negative x (Mills-ratio asymptotic).

    The underflow floor is applied WITHOUT constructing a denormal: XLA's
    CPU compute threads run with flush-to-zero/denormals-are-zero, and the
    telemetry ledger (§15) evaluates this inside an ``io_callback`` on such
    a thread — there ``max(p, 5e-324)`` flushes to 0.0 and ``math.log``
    raises.  The precomputed constant is ``log(5e-324)``, so results are
    bit-identical to the historical expression on normal threads.
    """
    if x > -30.0:
        p = _phi(x)
        return math.log(p) if p > 0.0 else -744.4400719213812
    a = -x
    return -0.5 * a * a - 0.5 * math.log(2.0 * math.pi) - math.log(a)


# ---------------------------------------------------------------------------
# RDP
# ---------------------------------------------------------------------------

def gaussian_rdp_epsilon(rho: float, delta: float) -> float:
    """min over alpha of  alpha * rho + log(1/delta)/(alpha - 1).

    ``rho`` is the per-unit-alpha RDP rate (paper notation: Gaussian with
    sensitivity 2C and std sigma has rho = 2 C^2 / sigma^2).  The optimum is
    alpha* = 1 + sqrt(log(1/delta)/rho), giving eps = rho + 2 sqrt(rho log(1/delta)).
    """
    if rho <= 0.0:
        return 0.0
    l = math.log(1.0 / delta)
    return rho + 2.0 * math.sqrt(rho * l)


# ---------------------------------------------------------------------------
# GDP / analytic Gaussian
# ---------------------------------------------------------------------------

def gdp_delta(mu: float, eps: float) -> float:
    """Balle-Wang delta(eps) for a mu-GDP (Gaussian) mechanism.

    The second term is evaluated in log space: exp(eps) overflows float64 past
    eps ~ 709 while Phi(-mu/2 - eps/mu) underflows, but their product is <= 1.
    """
    if mu <= 0.0:
        return 0.0
    first = _phi(mu / 2.0 - eps / mu)
    log_second = eps + _log_phi(-mu / 2.0 - eps / mu)
    second = math.exp(log_second) if log_second < 700.0 else float("inf")
    return first - second


def gdp_epsilon(mu: float, delta: float) -> float:
    """Invert delta(eps) for eps >= 0 by bisection (delta(eps) is decreasing)."""
    if mu <= 0.0:
        return 0.0
    if gdp_delta(mu, 0.0) <= delta:
        return 0.0  # the delta target is met with no epsilon at all
    lo, hi = 0.0, 1.0
    while gdp_delta(mu, hi) > delta:
        hi *= 2.0
        if hi > 1e6:
            return float("inf")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if gdp_delta(mu, mid) > delta:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def gdp_mu_for_epsilon(eps: float, delta: float) -> float:
    """Largest GDP parameter mu whose (eps, delta) curve meets the target.

    The inverse of ``gdp_epsilon`` in mu: ``gdp_epsilon`` is increasing in mu
    (more privacy loss per unit noise), so bisection on mu finds the largest
    mechanism the budget admits.  This is how a per-client epsilon budget
    turns into a per-client noise scale (``sigma_for_epsilon``).
    """
    if eps <= 0.0:
        raise ValueError(f"eps must be > 0, got {eps}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    lo, hi = 0.0, 1.0
    while gdp_epsilon(hi, delta) < eps:
        lo = hi
        hi *= 2.0
        if hi > 1e8:  # pragma: no cover - astronomically loose budget
            return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if gdp_epsilon(mid, delta) < eps:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def sigma_for_epsilon(eps: float, delta: float,
                      sensitivity: float = 1.0) -> float:
    """Noise std giving a Gaussian release of ``sensitivity`` exactly
    (eps, delta)-DP (via the tight GDP curve: sigma = sensitivity / mu).

    This is the per-client calibration of the heterogeneous-privacy
    mechanism (``PerClientGaussian``): client i's budget eps_i maps to
    sigma_i = 2C / gdp_mu_for_epsilon(eps_i, delta) — larger budgets, less
    noise.  Float64 Python, config time only.
    """
    if sensitivity <= 0.0:
        raise ValueError(f"sensitivity must be > 0, got {sensitivity}")
    return sensitivity / gdp_mu_for_epsilon(eps, delta)


def subsampled_gdp_mu(mu_round: float, q: float, rounds: int) -> float:
    """Total GDP parameter of T q-subsampled rounds — amplification by
    subsampling (Bu, Dong, Long & Su 2020, "Deep learning with Gaussian
    differential privacy", Thm. 5 CLT).

    Each round releases through a mu_round-GDP Gaussian mechanism on a
    Poisson-sampled cohort (every client participates independently w.p. q —
    exactly ``CohortSpec(q=...)``); the T-fold composition converges to

        mu_total = q * sqrt(T * (e^{mu_round^2} - 1)).

    q = 1 short-circuits to the exact full-participation composition
    ``mu_round * sqrt(T)`` (the CLT expression is an over-estimate there, and
    no amplification applies).  The CLT is asymptotic in T with q*sqrt(T)
    held moderate — the federated regime (T in the tens-to-thousands,
    q << 1) it was derived for.
    """
    if q >= 1.0:
        return mu_round * math.sqrt(rounds)
    if q <= 0.0 or rounds <= 0:
        return 0.0
    x = mu_round * mu_round
    if x > 700.0:
        # exp overflows float64 here; the budget is effectively infinite
        # (a 1/q-inflated conditional release at tiny q) — report inf, and
        # gdp_epsilon(inf, delta) propagates it as eps=inf rather than
        # crashing the report
        return float("inf")
    return q * math.sqrt(rounds * (math.exp(x) - 1.0))


def composed_gdp_mu(mus, q: float = 1.0) -> float:
    """Total GDP parameter of a NON-UNIFORM per-round sequence ``mus``.

    The schedule generalization of ``subsampled_gdp_mu``: round t releases
    through a mu_t-GDP Gaussian mechanism (a sigma(t) noise schedule gives a
    different mu_t each round), and

        q = 1:  mu_total = sqrt(sum_t mu_t^2)                 (exact — the
                 PLD of a Gaussian composition is Gaussian regardless of
                 whether the per-round scales match)
        q < 1:  mu_total = q * sqrt(sum_t (e^{mu_t^2} - 1))   (the Bu et al.
                 2020 CLT with the per-round Berry-Esseen terms summed
                 instead of multiplied by T — uniform schedules reduce to
                 ``subsampled_gdp_mu`` exactly)

    A uniform sequence reproduces ``subsampled_gdp_mu(mu, q, T)`` bit-for-bit
    in both regimes (pinned by tests/test_schedules.py).
    """
    mus = list(mus)
    if not mus:
        return 0.0
    if any(m < 0.0 for m in mus):
        raise ValueError("per-round mu must be >= 0")
    if len(set(mus)) == 1:
        # uniform schedules delegate to the uniform accountant so the
        # homogeneous reduction is EXACT (same floats, not same-to-ulps)
        return subsampled_gdp_mu(mus[0], q, len(mus))
    if q >= 1.0:
        return math.sqrt(sum(m * m for m in mus))
    if q <= 0.0:
        return 0.0
    total = 0.0
    for m in mus:
        x = m * m
        if x > 700.0:
            return float("inf")  # same overflow contract as subsampled_gdp_mu
        total += math.exp(x) - 1.0
    return q * math.sqrt(total)


# ---------------------------------------------------------------------------
# Paper-level budget helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrivacyReport:
    """Privacy budget of one algorithm/run: numerical (GDP) and RDP epsilons at delta."""
    setting: str
    eps_numerical: float      # tight (GDP/analytic) — comparable to Table 1
    eps_rdp: float            # the paper's stated RDP bound (Props. 4.1/4.2)
    delta: float
    mu: float                 # total GDP parameter (0 for pure-DP mechanisms)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"{self.setting}: eps={self.eps_numerical:.3f} (numerical), "
                f"{self.eps_rdp:.3f} (RDP bound), delta={self.delta:g}")


def ldp_gaussian_budget(clip_norm: float, sigma: float, delta: float) -> PrivacyReport:
    """Proposition 4.1 (Gaussian): per-release client guarantee.

    Sensitivity of one client's clipped update is 2C (substitution), noise std
    sigma => rho = 2 C^2 / sigma^2 and mu = 2C / sigma.  Identical for
    DP-FedAvg and LDP-FedEXP (the step size is computed server-side from the
    already-released c_i).
    """
    mu = 2.0 * clip_norm / sigma
    rho = 2.0 * clip_norm**2 / sigma**2
    return PrivacyReport("LDP (Gaussian)", gdp_epsilon(mu, delta),
                         gaussian_rdp_epsilon(rho, delta), delta, mu)


def cdp_budget(clip_norm: float, sigma: float, num_clients: int, rounds: int,
               delta: float, sigma_xi: float | None = None,
               sampling_q: float = 1.0) -> PrivacyReport:
    """Proposition 4.2: T-round central guarantee, amplification-aware.

    Per round: mean release has sensitivity 2C/M with noise std sigma/sqrt(M)
    (the paper's eps^(t) ~ N(0, sigma^2/M)), i.e. mu_mean = 2C/(sigma sqrt(M));
    the FedEXP numerator has sensitivity C^2/M with std sigma_xi, i.e.
    mu_xi = C^2/(M sigma_xi).  Pass ``sigma_xi=None`` for DP-FedAvg (no
    numerator release).

    ``sampling_q < 1`` is the per-round client sampling rate (``CohortSpec``)
    and models the engine's ACTUAL sampled release: the mean is normalized by
    the realized cohort (~qM clients) while the noise std stays sigma/sqrt(M),
    so the CONDITIONAL per-round sensitivity (given the swapped client
    participates, which happens w.p. q) is 2C/(qM) — the full-participation
    mu inflated by 1/q — and the same inflation applies to the numerator
    release.  The tight eps_numerical then composes via the subsampled-GDP
    CLT (``subsampled_gdp_mu``); note the inflation and the amplification
    cancel to first order, so sampling at a FIXED sigma is not a free privacy
    win — honest accounting, not the naive q-discount.  eps_rdp composes the
    inflated conditional release UNAMPLIFIED — a valid (loose) upper bound,
    flagged by the report name, since subsampled-RDP has no closed form here.
    Fixed-size cohorts are approximated as Poisson at rate size/M.
    """
    m = float(num_clients)
    q = sampling_q if 0.0 < sampling_q < 1.0 else 1.0
    mu_mean = 2.0 * clip_norm / (sigma * math.sqrt(m)) / q
    rho = rounds * 2.0 * clip_norm**2 / (m * sigma**2) / q**2
    mu_round_sq = mu_mean**2
    if sigma_xi is not None and sigma_xi > 0.0:
        mu_xi = clip_norm**2 / (m * sigma_xi) / q
        mu_round_sq += mu_xi**2
        rho += rounds * clip_norm**4 / (2.0 * m**2 * sigma_xi**2) / q**2
    mu = subsampled_gdp_mu(math.sqrt(mu_round_sq), q, rounds)
    name = "CDP (FedEXP)" if sigma_xi else "CDP (FedAvg)"
    if sampling_q < 1.0:
        name += f", q={sampling_q:g} subsampled"
    return PrivacyReport(name, gdp_epsilon(mu, delta),
                         gaussian_rdp_epsilon(rho, delta), delta, mu)


def schedule_ldp_budget(clip_norm: float, sigmas, delta: float) -> PrivacyReport:
    """T-round LDP budget of a NON-UNIFORM noise schedule sigma(t).

    Unlike the uniform ``ldp_gaussian_budget`` (per-release — every round's
    release carries the same guarantee), a schedule's rounds differ, so the
    honest client-level guarantee is the COMPOSITION over the executed
    rounds: per-round mu_t = 2C / sigma_t summed in GDP (exact — Gaussian
    PLDs compose in closed form), rho_t = 2 C^2 / sigma_t^2 summed for the
    RDP upper bound.  No subsampling amplification is applied: local
    guarantees hold against the client's own releases and do not amplify
    under central sampling of who participates.

    A length-1 schedule with sigma_0 == sigma reproduces
    ``ldp_gaussian_budget(C, sigma, delta)``'s numbers exactly.
    """
    sigmas = list(sigmas)
    if not sigmas:
        raise ValueError("schedule_ldp_budget needs at least one round")
    if any(s <= 0.0 for s in sigmas):
        raise ValueError("every scheduled sigma must be > 0")
    mu = composed_gdp_mu([2.0 * clip_norm / s for s in sigmas], q=1.0)
    rho = sum(2.0 * clip_norm**2 / s**2 for s in sigmas)
    return PrivacyReport(f"LDP (Gaussian, {len(sigmas)}-round schedule)",
                         gdp_epsilon(mu, delta),
                         gaussian_rdp_epsilon(rho, delta), delta, mu)


def schedule_cdp_budget(clip_norm: float, sigmas, num_clients: int,
                        delta: float, sigma_xis=None,
                        sampling_q: float = 1.0) -> PrivacyReport:
    """T-round central budget of a NON-UNIFORM noise schedule sigma(t).

    The schedule generalization of ``cdp_budget``: round t's mean release
    has mu_t = 2C/(sigma_t sqrt(M))/q (conditional-sensitivity inflation as
    in ``cdp_budget``) and, when ``sigma_xis`` names per-round numerator
    noise scales, the numerator release adds (C^2/(M sigma_xi_t)/q)^2 to
    mu_t^2.  The per-round mus compose via ``composed_gdp_mu`` (exact
    Gaussian composition at q=1, summed-CLT amplification at q<1); rho sums
    per round for the RDP upper bound (composed unamplified — same
    upper-bound caveat as ``cdp_budget``).

    A uniform schedule reproduces ``cdp_budget(C, sigma, M, T, delta, ...)``
    exactly (the composition helpers short-circuit uniform sequences to the
    uniform accountants).
    """
    sigmas = list(sigmas)
    if not sigmas:
        raise ValueError("schedule_cdp_budget needs at least one round")
    if any(s <= 0.0 for s in sigmas):
        raise ValueError("every scheduled sigma must be > 0")
    if sigma_xis is not None:
        sigma_xis = list(sigma_xis)
        if len(sigma_xis) != len(sigmas):
            raise ValueError(
                f"sigma_xis has {len(sigma_xis)} entries for a "
                f"{len(sigmas)}-round schedule")
    m = float(num_clients)
    q = sampling_q if 0.0 < sampling_q < 1.0 else 1.0
    mus, rho = [], 0.0
    for t, s in enumerate(sigmas):
        mu_sq = (2.0 * clip_norm / (s * math.sqrt(m)) / q) ** 2
        rho += 2.0 * clip_norm**2 / (m * s**2) / q**2
        if sigma_xis is not None and sigma_xis[t] > 0.0:
            mu_sq += (clip_norm**2 / (m * sigma_xis[t]) / q) ** 2
            rho += clip_norm**4 / (2.0 * m**2 * sigma_xis[t]**2) / q**2
        mus.append(math.sqrt(mu_sq))
    mu = composed_gdp_mu(mus, q)
    name = ("CDP (FedEXP" if sigma_xis is not None else "CDP (FedAvg")
    name += f", {len(sigmas)}-round schedule)"
    if sampling_q < 1.0:
        name += f", q={sampling_q:g} subsampled"
    return PrivacyReport(name, gdp_epsilon(mu, delta),
                         gaussian_rdp_epsilon(rho, delta), delta, mu)


def privunit_budget(eps0: float, eps1: float, eps2: float) -> PrivacyReport:
    """Lemma B.1: PrivUnit x ScalarDP is pure (eps0 + eps1 + eps2)-LDP."""
    eps = eps0 + eps1 + eps2
    return PrivacyReport("LDP (PrivUnit)", eps, eps, 0.0, 0.0)
