"""PrivUnit, ScalarDP and per-client sigmas (counterpart of the PrivUnit
section and ``per_client_sigmas`` of repro/core/mechanisms.py).

- PrivUnit (Bhowmick et al., 2018), Algorithm 5: privatizes the *direction*
  of an update on the unit sphere with pure epsilon-DP;
- ScalarDP, Algorithm 6: privatizes the update *norm* with randomized
  rounding and randomized response;
- the norm-squared estimator of Algorithm 4 that the LDP-FedEXP(PrivUnit)
  step size (Eq. 7) reads;
- ``per_client_sigmas``, the heterogeneous-privacy calibration (each
  client's sigma from its own epsilon).

The static constants (gamma, the unbiasing scale m, ScalarDP's a, b, k and
the variance-bound constants c1, c2, c3) are float64 Python computed once per
configuration, as in the JAX package (copies of its ``_betacf``,
``_betainc_f64``, ``_log_beta`` and ``_gamma_from_eps1``).

The randomizers are functions of materialized draws, batched over M rows:
per client a cap uniform and a quantile uniform (``privunit_quantile``), a
(d,) normal (``privunit_direction``), and ScalarDP's rounding uniform, keep
uniform and integer in [0, k) (``scalardp_magnitude``).  The cap is sampled
exactly by the tangent-normal decomposition: ``v = t u + sqrt(1 - t^2) w``
with ``w`` uniform on the sphere orthogonal to ``u`` and ``(1 + t) / 2`` a
Beta(alpha, alpha) draw truncated to the cap, ``alpha = (d - 1) / 2``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "PrivUnitParams",
    "ScalarDPParams",
    "make_privunit_params",
    "make_scalardp_params",
    "privunit_quantile",
    "privunit_direction",
    "scalardp_magnitude",
    "privunit_randomize",
    "estimate_norm_sq",
    "per_client_sigmas",
]


# ---------------------------------------------------------------------------
# float64 incomplete beta (configuration time).  Continued-fraction
# evaluation, Numerical Recipes §6.4.
# ---------------------------------------------------------------------------

def _betacf(a: float, b: float, x: float) -> float:
    MAXIT, EPS, FPMIN = 300, 3e-14, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < EPS:
            break
    return h


def _betainc_f64(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b) in float64."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    front = math.exp(a * math.log(x) + b * math.log1p(-x) - lbeta)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - math.exp(b * math.log1p(-x) + a * math.log(x) - lbeta) * _betacf(b, a, 1.0 - x) / b


def _log_beta(a: float, b: float) -> float:
    return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)


# ---------------------------------------------------------------------------
# PrivUnit (Algorithm 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrivUnitParams:
    """Static constants for PrivUnit(eps0, eps1) in dimension d."""

    dim: int
    eps0: float
    eps1: float
    p: float          # cap probability  e^{eps0} / (1 + e^{eps0})
    gamma: float      # cap height
    m: float          # unbiasing normalizer; ||z|| = 1/m
    alpha: float      # (d-1)/2
    tau: float        # (1+gamma)/2
    i_tau: float      # I_tau(alpha, alpha)


def _gamma_from_eps1(d: int, eps1: float) -> float:
    """The largest cap height gamma Algorithm 5 permits: the max of the
    gammas admitted by the two sufficient conditions of Bhowmick et al. (2018),
      (A)  gamma <= (e^{eps1}-1)/(e^{eps1}+1) * sqrt(pi / (2(d-1)))
      (B)  eps1 >= 0.5*log d + log 6 - (d-1)/2 * log(1-gamma^2) + log gamma,
           with gamma >= sqrt(2/d).
    """
    gamma_a = (math.expm1(eps1) / (math.exp(eps1) + 1.0)) * math.sqrt(math.pi / (2.0 * (d - 1)))

    def rhs(g: float) -> float:
        """Condition (B)'s right-hand side as a function of gamma."""
        return 0.5 * math.log(d) + math.log(6.0) - 0.5 * (d - 1) * math.log1p(-g * g) + math.log(g)

    g_lo = math.sqrt(2.0 / d)
    gamma_b = -1.0
    if g_lo < 1.0 and rhs(g_lo) <= eps1:
        lo, hi = g_lo, 1.0 - 1e-12
        if rhs(hi) <= eps1:
            gamma_b = hi
        else:
            for _ in range(200):
                mid = 0.5 * (lo + hi)
                if rhs(mid) <= eps1:
                    lo = mid
                else:
                    hi = mid
            gamma_b = lo
    gamma = max(gamma_a, gamma_b)
    return min(max(gamma, 1e-8), 1.0 - 1e-9)


def make_privunit_params(dim: int, eps0: float, eps1: float) -> PrivUnitParams:
    """PrivUnit parameters for dimension ``dim`` at budgets (eps0, eps1).

    Derives the cap probability p from eps0, the cap height gamma from eps1
    and the debiasing normalizer m; raises when the configuration admits no
    positive finite normalizer (increase eps0).
    """
    if dim < 2:
        raise ValueError("PrivUnit requires d >= 2")
    p = math.exp(eps0) / (1.0 + math.exp(eps0))
    gamma = _gamma_from_eps1(dim, eps1)
    alpha = 0.5 * (dim - 1)
    tau = 0.5 * (1.0 + gamma)
    i_tau = _betainc_f64(alpha, alpha, tau)
    i_tau = min(max(i_tau, 1e-300), 1.0 - 1e-16)
    # m = (1-gamma^2)^alpha / (2^{d-2} (d-1)) * [ p/(B - B_tau) - (1-p)/B_tau ]
    # with B = B(alpha, alpha), B_tau = B(tau; alpha, alpha) = I_tau * B.
    log_common = alpha * math.log1p(-gamma * gamma) - (dim - 2) * math.log(2.0) \
        - math.log(dim - 1) - _log_beta(alpha, alpha)
    term_cap = p * math.exp(log_common - math.log1p(-i_tau))
    term_comp = (1.0 - p) * math.exp(log_common - math.log(i_tau))
    m = term_cap - term_comp
    if not (m > 0.0) or not math.isfinite(m):
        raise ValueError(
            f"PrivUnit normalizer m={m!r} is not positive/finite for d={dim}, "
            f"eps0={eps0}, eps1={eps1}; increase eps0.")
    return PrivUnitParams(dim=dim, eps0=eps0, eps1=eps1, p=p, gamma=gamma, m=m,
                          alpha=alpha, tau=tau, i_tau=i_tau)


def privunit_quantile(cap_u, u01, params: PrivUnitParams) -> torch.Tensor:
    """The cap coordinate t = <v, u> of each client's release, (M,) float64 on the host.

    ``cap_u < p`` puts the release in the cap, and then ``(1 + t) / 2`` is
    the Beta(alpha, alpha) quantile of ``I_tau + u01 (1 - I_tau)``, else that
    of ``u01 I_tau``.  The inverse of x -> I_x(alpha, alpha) is
    ``scipy.special.betaincinv`` in float64 on the host (the draws are host
    values: no device work, no sync).  The JAX package bisects a float32
    betainc instead, whose quantile is off by up to 3.6e-5 at d = 131072.
    """
    from scipy.special import betaincinv

    cap_u, u01 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
                  for x in (cap_u, u01))
    y = np.where(cap_u < np.float32(params.p), params.i_tau + u01 * (1.0 - params.i_tau),
                 u01 * params.i_tau)
    t = 2.0 * betaincinv(params.alpha, params.alpha, y) - 1.0
    return torch.from_numpy(np.clip(t, -1.0 + 1e-7, 1.0 - 1e-7))


def privunit_direction(unit: torch.Tensor, t: torch.Tensor, g: torch.Tensor,
                       params: PrivUnitParams) -> torch.Tensor:
    """PrivUnit (Algorithm 5) of M unit rows: ``(t u + sqrt(1 - t^2) w) / m``.

    ``unit`` (M, d), ``t`` (M,) from ``privunit_quantile``, ``g`` (M, d)
    N(0, 1) whose component orthogonal to ``u`` gives ``w``.  Each returned
    row has norm 1/m and expectation ``u``.
    """
    t = t[:, None]
    g_perp = g - torch.sum(g * unit, dim=-1, keepdim=True) * unit
    w_hat = g_perp / torch.clamp(torch.linalg.vector_norm(g_perp, dim=-1, keepdim=True),
                                 min=1e-12)
    v = t * unit + torch.sqrt(torch.clamp(1.0 - t * t, min=0.0)) * w_hat
    return v / params.m


# ---------------------------------------------------------------------------
# ScalarDP (Algorithm 6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalarDPParams:
    """Static constants for ScalarDP(eps2) with magnitudes in [0, r_max]."""

    eps2: float
    r_max: float       # = clipping threshold C
    k: int             # ceil(e^{eps2/3})
    a: float           # debias scale
    b: float           # debias offset
    c1: float          # variance-bound constants of Algorithm 4
    c2: float
    c3: float


def make_scalardp_params(eps2: float, r_max: float) -> ScalarDPParams:
    """ScalarDP magnitude-release lattice for budget eps2 on [0, r_max].

    k = ceil(e^{eps2/3}) lattice points with the debias transform (a, b)
    and the variance-bound constants (c1, c2, c3) of Algorithm 4.
    """
    k = int(math.ceil(math.exp(eps2 / 3.0)))
    e = math.exp(eps2)
    a = ((e + k) / (e - 1.0)) * (r_max / k)
    b = k * (k + 1.0) / (2.0 * (e + k))
    c1 = (k + 1.0) / (e - 1.0)
    c2 = -c1 * r_max
    c3 = (c1 + 1.0) * r_max**2 / (4.0 * k * k) + c1 * r_max**2 * (
        (2.0 * k + 1.0) * (e + k) / (6.0 * k * (e - 1.0)) - (k + 1.0) / (4.0 * (e - 1.0)))
    return ScalarDPParams(eps2=eps2, r_max=r_max, k=k, a=a, b=b, c1=c1, c2=c2, c3=c3)


def scalardp_magnitude(r: torch.Tensor, round_u: torch.Tensor, keep_u: torch.Tensor,
                       u_int: torch.Tensor, params: ScalarDPParams) -> torch.Tensor:
    """ScalarDP (Algorithm 6): eps2 pure-DP unbiased estimates of M norms ``r`` in [0, C].

    ``round_u`` rounds ``r k / C`` down with probability ``ceil - x``;
    ``keep_u`` keeps the lattice point with probability
    ``e^eps2 / (e^eps2 + k)``; otherwise ``u_int``, uniform in [0, k), is
    shifted past it to a uniform other point.
    """
    k = params.k
    scaled = torch.clamp(r / params.r_max, 0.0, 1.0) * k
    j_floor = torch.floor(scaled)
    take_floor = round_u < torch.ceil(scaled) - scaled
    j = torch.clamp(torch.where(take_floor, j_floor, torch.ceil(scaled)).to(torch.int32), 0, k)
    keep = keep_u < math.exp(params.eps2) / (math.exp(params.eps2) + k)
    u = u_int.to(torch.int32)
    u = torch.where(u >= j, u + 1, u)
    j_hat = torch.where(keep, j, u)
    return params.a * (j_hat.to(torch.float32) - params.b)


# ---------------------------------------------------------------------------
# Combined randomizer + norm estimation (Algorithm 4)
# ---------------------------------------------------------------------------

def privunit_randomize(deltas: torch.Tensor, t: torch.Tensor, g: torch.Tensor,
                       round_u: torch.Tensor, keep_u: torch.Tensor, u_int: torch.Tensor,
                       pu: PrivUnitParams, sc: ScalarDPParams) -> torch.Tensor:
    """LocalRandomizer for LDP(PrivUnit) of M rows: ``ScalarDP(||d||) * PrivUnit(d/||d||)``.

    Unbiased: ``E[c] = delta`` (Lemma B.1); pure (eps0+eps1+eps2)-LDP.
    """
    nrm = torch.linalg.vector_norm(deltas, dim=-1)
    unit = deltas / torch.clamp(nrm, min=1e-12)[:, None]
    z = privunit_direction(unit, t, g, pu)
    return scalardp_magnitude(nrm, round_u, keep_u, u_int, sc)[:, None] * z


def estimate_norm_sq(c: torch.Tensor, pu: PrivUnitParams, sc: ScalarDPParams) -> torch.Tensor:
    """Algorithm 4: estimate each row's ``||Delta||^2`` from its PrivUnit release, (M,).

    Recovers the signed ScalarDP output from ``||c|| = |r_hat| / m`` by the
    lattice (r_hat/a + b is an integer iff the sign is positive, under the
    paper's assumption k(k+1)/(e^{eps2}+k) not in Z), then debiases through
    the variance upper bound:
        s_hat = (r_hat^2 - c2 * r_hat - c3) / (1 + c1),   E[s_hat] <= ||Delta||^2.
    """
    r_tilde = pu.m * torch.linalg.vector_norm(c, dim=-1)
    j_pos = r_tilde / sc.a + sc.b
    j_neg = -r_tilde / sc.a + sc.b
    dist_pos = torch.abs(j_pos - torch.round(j_pos))
    dist_neg = torch.abs(j_neg - torch.round(j_neg))
    r_hat = torch.where(dist_pos <= dist_neg, r_tilde, -r_tilde)
    return (r_hat**2 - sc.c2 * r_hat - sc.c3) / (1.0 + sc.c1)


def per_client_sigmas(epsilons, delta: float, clip_norm: float) -> tuple[float, ...]:
    """Per-client noise stds meeting each (eps_i, delta) at sensitivity 2C.

    Inverts the Gaussian single-release GDP curve (``sigma_for_epsilon``)
    for each client, in float64 on the host: larger budgets get smaller
    sigmas, and ``1 / sigma_i^2`` are the inverse-variance aggregation
    weights of ``ldp-fedexp-perclient``.  Each distinct epsilon is inverted
    once (a bisection of ~20 ms): budgets come in a few tiers.
    """
    from repro_torch.core import accounting
    eps = tuple(float(e) for e in epsilons)
    if not eps:
        raise ValueError("per_client_sigmas requires at least one epsilon")
    if any(e <= 0 for e in eps):
        raise ValueError("per-client epsilons must be positive")
    sigma_of = {e: accounting.sigma_for_epsilon(e, delta, sensitivity=2.0 * clip_norm)
                for e in set(eps)}
    return tuple(sigma_of[e] for e in eps)
