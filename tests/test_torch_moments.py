"""The port's masked-moment protocol against the JAX package's, on the CPU.

``partial_clip_moments`` and ``raw_moments`` with a mask, row weights, both,
operand noise and NaN in masked rows (JAX on its ``jnp`` backend and on the
Pallas kernel in interpret mode); each mechanism's ``moments`` and
``finalize``; and ``local_moments`` / ``apply_from_moments`` for every
registry name the port builds, over a contiguous block and a gathered one.
The port is fed the JAX round's own randomness: its materialized LDP noise
(rows keyed by global client index), its CDP draws and its PrivUnit draws
per client.  Float32 results are held at rtol 1e-5, a vector's atol 1e-5
times its largest entry.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compose as jcomp  # noqa: E402
from repro.core.algorithm import client_keys  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import compose as tcomp  # noqa: E402
from repro_torch.core.algorithm import RoundNoise  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402

M, D = 40, 24
EPS = dict(eps0=2.0, eps1=2.0, eps2=2.0)
# the composed names; dp-scaffold's rounds are held in test_torch_scaffold.py
COMPOSED = [n for n in list_algorithms() if n != "dp-scaffold"]
MARGIN = 1e-4   # relative distance of every row norm from the adaptive clip's C


def close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def close(got, want, rtol=1e-5, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, err_msg=what)


def algo_kwargs(name, m=M, d=D):
    """make_algorithm kwargs of ``name`` for both packages at the test size."""
    c = 1.0
    if name in ("fedavg", "fedexp"):
        return {}
    if name == "ldp-fedexp-perclient":
        return dict(clip_norm=c, epsilons=tuple([0.5] * (m // 4) + [2.0] * (m // 4)
                                                + [8.0] * (m - m // 2)), delta=1e-5)
    if "privunit" in name:
        kw = dict(clip_norm=c, dim=d, **EPS)
    elif "cdp" in name:
        kw = dict(clip_norm=c, sigma=5 * c / math.sqrt(m), num_clients=m)
    else:
        kw = dict(clip_norm=c, sigma=0.7 * c)
    if "adaptive-clip" in name:
        kw["c0"] = c
        kw["sigma_b"] = 4.0
        if "cdp" in name:
            kw = dict(z_mult=1.2, num_clients=m, c0=c, sigma_b=4.0)
    if "schedule" in name:
        kw["decay"] = 0.97
    return kw


def jax_privunit_draws(keys, d, k):
    """Per client the six draws of JAX's ``privunit_randomize`` on its key."""
    def one(key):
        k_dir, k_mag = jax.random.split(key)
        k_cap, k_t, k_w = jax.random.split(k_dir, 3)
        k_round, k_rr, k_unif = jax.random.split(k_mag, 3)
        return (jax.random.uniform(k_cap), jax.random.uniform(k_t),
                jax.random.normal(k_w, (d,), jnp.float32), jax.random.uniform(k_round),
                jax.random.uniform(k_rr), jax.random.randint(k_unif, (), 0, k))
    names = ("cap_u", "u01", "g", "round_u", "keep_u", "u_int")
    return {n: torch.tensor(np.asarray(v)) for n, v in zip(names, jax.vmap(one)(keys))}


def round_noise_of(jalg, key, m, d, t=None, *, raw=False) -> RoundNoise:
    """The JAX round's randomness as the port's staged ``RoundNoise``, for all
    m clients: the per-client rows keyed by global index, so any block reads
    its own.  A compressed composition's central noise is its (kc,) draw,
    and its plan JAX's ``aggregation.plan(fold_in(key, COMPRESS_TAG), d)``.
    As the port's stage does, PrivUnit's cap and quantile uniforms become
    the port's quantiles, and a round-indexed schedule's sigma(t) (JAX's)
    rides along as a 0-d float32 tensor; ``raw`` leaves the draws as drawn,
    for the port's own stage."""
    k_mech, extra = jalg._split_keys(key)
    mech = jalg._mech_at(t)
    noise = RoundNoise()
    agg = getattr(jalg, "aggregation", None)
    if agg is not None and agg.is_compressed:
        plan = jalg._round_plan(key, d)
        noise.plan = (tuple(torch.tensor(np.asarray(x)) for x in plan)
                      if isinstance(plan, tuple) else torch.tensor(np.asarray(plan)))
        d = agg.comm_floats(d)   # the central noise of a (kc,) mean
    if isinstance(mech, jcomp.GaussianLDP):
        noise.ldp = torch.tensor(np.asarray(jagg.materialize_ldp_noise(k_mech, m, d,
                                                                       mech.sigma)))
    elif isinstance(mech, jcomp.PerClientGaussian):
        noise.ldp = torch.tensor(np.asarray(jagg.materialize_ldp_noise(k_mech, m, d, 1.0)))
    elif isinstance(mech, jcomp.PrivUnitLDP):
        for f, v in jax_privunit_draws(client_keys(k_mech, m, 0), d, mech.sc.k).items():
            setattr(noise, f, v)
        tmech = tcomp.PrivUnitLDP(clip_norm=mech.clip_norm, eps0=mech.eps0, eps1=mech.eps1,
                                  eps2=mech.eps2, dim=mech.dim)
        for f, v in ({} if raw else tmech.stage(noise)).items():
            setattr(noise, f, v)
    elif isinstance(mech, jcomp.CentralGaussian):
        noise.central = torch.tensor(np.asarray(jax.random.normal(k_mech, (d,))))
    if getattr(jalg.mechanism, "is_round_indexed", False) and not raw:
        noise.sigma_t = torch.tensor(float(mech.sigma), dtype=torch.float32)
    if mech.needs_xi_key and jalg.step.uses_extrapolation and extra:
        noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
    if jalg.step.needs_clip_bits:
        noise.bit = torch.tensor(np.asarray(jax.random.normal(extra[-1], ())))
    return noise


def deltas_for(rng, m, d, clip=1.0):
    """Rows with norms spread over [0.05, 1.9] C, each at least MARGIN C away
    from C (the clip-bit count is a float32 decision in both packages)."""
    x = rng.standard_normal((m, d))
    norms = clip * (0.05 + 1.85 * rng.random(m))
    norms = np.where(np.abs(norms - clip) < 0.01 * clip, norms + 0.05 * clip, norms)
    return (x * (norms / np.linalg.norm(x, axis=1))[:, None]).astype(np.float32)


def masks(rng, m):
    """A {0, 1} mask (half the clients) and a multiplicity mask."""
    binary = (rng.random(m) < 0.5).astype(np.float32)
    binary[0] = 1.0
    mult = rng.integers(0, 3, m).astype(np.float32)
    mult[1] = 2.0
    return {"binary": binary, "multiplicity": mult}


def moments_close(tm, jm, what):
    close_vec(tm.sum_c.numpy(), jm.sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tm, f), getattr(jm, f), what=f"{what}: {f}")


# ---------------------------------------------------------------------------
# partial_clip_moments and raw_moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_backend", ["jnp", "kernel"])
@pytest.mark.parametrize("port_backend", ["torch", "kernel", "kernel-fused"])
@pytest.mark.parametrize("mask_kind", [None, "binary", "multiplicity"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_noise", [False, True])
def test_partial_clip_moments_match_jax(jax_backend, port_backend, mask_kind, weighted,
                                        with_noise):
    m, d = 37, 29
    rng = np.random.default_rng(3)
    u = deltas_for(rng, m, d)
    noise = (0.3 * rng.standard_normal((m, d))).astype(np.float32) if with_noise else None
    mask = None if mask_kind is None else masks(rng, m)[mask_kind]
    weights = (0.2 + rng.random(m)).astype(np.float32) if weighted else None
    if mask is not None:
        u[mask == 0] = np.nan            # masked rows hold garbage: where, not multiply
        if with_noise:
            noise[mask == 0] = np.inf
    jm = jagg.partial_clip_moments(
        jnp.asarray(u), 1.0, None if noise is None else jnp.asarray(noise),
        weight_mask=None if mask is None else jnp.asarray(mask),
        row_weights=None if weights is None else jnp.asarray(weights), backend=jax_backend)
    tm = tagg.partial_clip_moments(
        torch.tensor(u), 1.0, None if noise is None else torch.tensor(noise),
        weight_mask=None if mask is None else torch.tensor(mask),
        row_weights=None if weights is None else torch.tensor(weights), backend=port_backend)
    moments_close(tm, jm, f"{mask_kind} weighted={weighted} noise={with_noise}")
    if mask is None and weights is None:
        assert tm.count == float(m)      # the static count, a host float


@pytest.mark.parametrize("mask_kind", [None, "binary", "multiplicity"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("binary_mask", [False, True])
def test_raw_moments_match_jax(mask_kind, weighted, binary_mask):
    m, d = 31, 17
    rng = np.random.default_rng(5)
    u = rng.standard_normal((m, d)).astype(np.float32)
    mask = None if mask_kind is None else masks(rng, m)[mask_kind]
    weights = (0.2 + rng.random(m)).astype(np.float32) if weighted else None
    if mask is not None:
        u[mask == 0] = np.nan
    jm = jagg.raw_moments(jnp.asarray(u), None if mask is None else jnp.asarray(mask),
                          None if weights is None else jnp.asarray(weights))
    tm = tagg.raw_moments(torch.tensor(u), None if mask is None else torch.tensor(mask),
                          None if weights is None else torch.tensor(weights),
                          binary_mask=binary_mask)
    moments_close(tm, jm, f"{mask_kind} weighted={weighted}")


def test_global_client_indices():
    assert torch.equal(tagg.global_client_indices(5, 4, "cpu"), torch.arange(5, 9))
    ids = torch.tensor([3, 0, 7])
    assert tagg.global_client_indices(ids, 3, "cpu") is ids
    np.testing.assert_array_equal(tagg.global_client_indices(5, 4, "cpu").numpy(),
                                  np.asarray(jagg.global_client_indices(5, 4)))


@pytest.mark.parametrize("backend", ["torch", "kernel", "kernel-fused"])
def test_seeded_noise_of_a_gathered_block_is_its_clients_rows(backend):
    """The port's own Threefry noise: a gathered block draws exactly its
    clients' rows of the dense cohort's noise, padding slots gated off."""
    from repro_torch.kernels.dp_aggregate import ref
    m, d, seed, sigma = 30, 21, 77, 0.6
    rng = np.random.default_rng(8)
    u = torch.tensor(deltas_for(rng, m, d))
    slots = torch.tensor([2, 5, 11, 12, 29, 0, 0])
    gate = torch.tensor([1, 1, 1, 1, 1, 0, 0], dtype=torch.float32)
    dense = ref.ldp_noise_ref(m, d, seed, sigma)
    got = tagg.partial_clip_moments(u[slots], 1.0, noise_seed=seed, noise_sigma=sigma,
                                    start=slots, weight_mask=gate, backend=backend)
    want = tagg.partial_clip_moments(u[slots], 1.0, dense[slots], weight_mask=gate,
                                     backend="torch")
    moments_close(got, want, backend)
    dense_mask = torch.zeros(m)
    dense_mask[slots[:5]] = 1.0
    whole = tagg.partial_clip_moments(u, 1.0, noise_seed=seed, noise_sigma=sigma,
                                      weight_mask=dense_mask, backend=backend)
    moments_close(got, whole, f"{backend}: gathered vs dense")


# ---------------------------------------------------------------------------
# Each mechanism's moments and finalize
# ---------------------------------------------------------------------------

MECHANISMS = {
    "noprivacy": (jcomp.NoPrivacy(), tcomp.NoPrivacy()),
    "gaussian": (jcomp.GaussianLDP(1.0, 0.7), tcomp.GaussianLDP(1.0, 0.7)),
    "perclient-uniform": (jcomp.PerClientGaussian(1.0, (2.0,) * M, 1e-5),
                          tcomp.PerClientGaussian(1.0, (2.0,) * M, 1e-5)),
    "perclient-mixed": (jcomp.PerClientGaussian(1.0, algo_kwargs("ldp-fedexp-perclient")
                                                ["epsilons"], 1e-5),
                        tcomp.PerClientGaussian(1.0, algo_kwargs("ldp-fedexp-perclient")
                                                ["epsilons"], 1e-5)),
    "privunit": (jcomp.PrivUnitLDP(1.0, 2.0, 2.0, 2.0, D),
                 tcomp.PrivUnitLDP(1.0, 2.0, 2.0, 2.0, D)),
    "central": (jcomp.CentralGaussian(clip_norm=1.0, sigma=0.8, num_clients=M),
                tcomp.CentralGaussian(clip_norm=1.0, sigma=0.8, num_clients=M)),
    "central-z": (jcomp.CentralGaussian(z_mult=1.2, num_clients=M),
                  tcomp.CentralGaussian(z_mult=1.2, num_clients=M)),
    "schedule": (jcomp.NoiseSchedule(inner=jcomp.GaussianLDP(1.0, 0.7), decay=0.9),
                 tcomp.NoiseSchedule(inner=tcomp.GaussianLDP(1.0, 0.7), decay=0.9)),
}


def _block(kind, rng):
    """(start for JAX, start for the port, mask) of a contiguous or gathered block."""
    if kind == "contiguous":
        return 8, 8, (rng.random(M - 8) < 0.6).astype(np.float32)
    slots = np.array([1, 4, 5, 9, 17, 22, 30, 38, 0, 0], np.int32)   # two padding slots
    mask = np.array([1] * 8 + [0, 0], np.float32)
    return jnp.asarray(slots), torch.tensor(slots, dtype=torch.int64), mask


@pytest.mark.parametrize("block", ["contiguous", "gathered"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(MECHANISMS))
def test_mechanism_moments_and_finalize_match_jax(name, weighted, block):
    jmech, tmech = MECHANISMS[name]
    t = 4
    jmech, tmech = jmech.at_round(t), tmech.at_round(t)
    rng = np.random.default_rng(11)
    jstart, tstart, mask = _block(block, rng)
    m = mask.shape[0]
    idx = (np.arange(tstart, tstart + m) if isinstance(tstart, int) else tstart.numpy())
    x = deltas_for(rng, M, D)[idx]
    x[mask == 0] = np.nan if name != "privunit" else 0.0
    weights = (0.2 + rng.random(m)).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(21)
    jalg = jcomp.ComposedAlgorithm(mechanism=jmech, step=jcomp.FedEXPStep())
    noise = round_noise_of(jalg, key, M, D)
    # the z_mult release reads the (adaptive) clip it is given
    jclip, tclip = (jnp.float32(0.9), torch.tensor(0.9)) if name == "central-z" else (None, None)
    key = jalg._split_keys(key)[0]        # the mechanism's own key, as the round splits it
    jmom, jex = jmech.moments(key, jnp.asarray(x), jnp.asarray(mask), jstart, jclip,
                              None if weights is None else jnp.asarray(weights))
    tmom, tex = tmech.moments(noise, torch.tensor(x), torch.tensor(mask), tstart, tclip,
                              None if weights is None else torch.tensor(weights))
    moments_close(tmom, jmom, name)
    assert set(tex) == set(jex)
    for k in jex:
        close(tex[k], jex[k], what=k)
    m_eff = jnp.sum(jnp.asarray(mask))
    jstats, jmore = jmech.finalize(key, jmom, jex, jclip, m_eff)
    tstats, tmore = tmech.finalize(noise, tmom, tex, tclip, torch.sum(torch.tensor(mask)))
    close_vec(tstats.cbar.numpy(), jstats.cbar)
    for f in ("mean_sq", "agg_sq", "mean_sq_clipped"):
        close(getattr(tstats, f), getattr(jstats, f), what=f)
    assert set(tmore) == set(jmore)
    for k in jmore:
        close(tmore[k], jmore[k], what=k)


# ---------------------------------------------------------------------------
# local_moments / apply_from_moments for every name
# ---------------------------------------------------------------------------

def test_every_port_name_is_covered():
    assert len(COMPOSED) == 16 and sorted(COMPOSED + ["dp-scaffold"]) == list_algorithms()


@pytest.mark.parametrize("block", ["contiguous", "gathered"])
@pytest.mark.parametrize("name", COMPOSED)
def test_local_moments_and_apply_from_moments_match_jax(name, block):
    kw = algo_kwargs(name)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    rng = np.random.default_rng(17)
    jstart, tstart, mask = _block(block, rng)
    m = mask.shape[0]
    idx = (np.arange(tstart, tstart + m) if isinstance(tstart, int) else tstart.numpy())
    x = deltas_for(rng, M, D)[idx]
    x[mask == 0] = 0.0                    # the round zeroes left-out rows at the source
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    t = 3
    key = jax.random.PRNGKey(40)
    noise = round_noise_of(jalg, key, M, D, t)
    jstate = jalg.init_state(jnp.asarray(w))
    tstate = talg.init_state(torch.tensor(w))
    jmoments = jalg.local_moments(key, jnp.asarray(w), jnp.asarray(x), jnp.asarray(mask),
                                  jstart, jstate, t=t)
    tmoments = talg.local_moments(noise, torch.tensor(w), torch.tensor(x), torch.tensor(mask),
                                  tstart, tstate, t)
    moments_close(tmoments[0], jmoments[0], name)
    assert set(tmoments[1]) == set(jmoments[1])
    for k, v in jmoments[1].items():
        close(tmoments[1][k], v, what=k)
    jw, jaux, jstate = jalg.apply_from_moments(key, jnp.asarray(w), jmoments, jstate, t=t)
    tw, taux, tstate = talg.apply_from_moments(noise, torch.tensor(w), tmoments, tstate, t)
    for f in ("eta_g", "eta_naive", "eta_target", "update_norm"):
        j, g = float(getattr(jaux, f)), float(getattr(taux, f))
        assert math.isnan(j) == math.isnan(g), f
        if not math.isnan(j):
            close(g, j, what=f)
    close_vec(tw.numpy(), jw)
    if "adaptive-clip" in name:
        close(tstate.clip, jstate.clip, what="clip")


@pytest.mark.parametrize("name", ["ldp-fedexp-perclient", "cdp-fedexp-adaptive-clip"])
def test_weighted_dense_round_takes_the_moment_route_as_jax(name):
    """Under WeightedAggregation the dense round is the moment round with an
    all-ones mask, in both packages."""
    kw = algo_kwargs(name)
    w_agg = tuple(float(v) for v in 0.3 + np.random.default_rng(2).random(M))
    jalg = jcomp.ComposedAlgorithm(mechanism=jax_make(name, **kw).mechanism,
                                   step=jax_make(name, **kw).step,
                                   aggregation=jcomp.WeightedAggregation(w_agg), name=name)
    talg = tcomp.ComposedAlgorithm(mechanism=make_algorithm(name, **kw).mechanism,
                                   step=make_algorithm(name, **kw).step,
                                   aggregation=tcomp.WeightedAggregation(w_agg), name=name)
    assert not talg.supports_static_count
    rng = np.random.default_rng(23)
    x = deltas_for(rng, M, D)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    key = jax.random.PRNGKey(41)
    noise = round_noise_of(jalg, key, M, D)
    jw, jaux, _ = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x),
                                            jalg.init_state(jnp.asarray(w)))
    tw, taux, _ = talg.apply_round_stateful(None, torch.tensor(w), torch.tensor(x),
                                            talg.init_state(torch.tensor(w)), noise)
    close(taux.eta_g, jaux.eta_g, what="eta_g")
    close_vec(tw.numpy(), jw)


def test_compressed_layers_are_refused_and_weighted_names_derived():
    """A compressed layer under an LDP mechanism is refused, as in JAX."""
    for pkg in (tcomp, jcomp):
        with pytest.raises(ValueError, match="LDP mechanism releases a full"):
            pkg.ComposedAlgorithm(mechanism=pkg.GaussianLDP(1.0, 0.5), step=pkg.FixedEta(),
                                  aggregation=pkg.RandKAggregation(k=4))
    alg = tcomp.compose_algorithm(tcomp.GaussianLDP(1.0, 0.5), tcomp.FedEXPStep(),
                                  tcomp.WeightedAggregation((1.0, 2.0)))
    want = jcomp.compose_algorithm(jcomp.GaussianLDP(1.0, 0.5), jcomp.FedEXPStep(),
                                   jcomp.WeightedAggregation((1.0, 2.0)))
    assert alg.name == want.name == "gaussianldp-weighted-fedexpstep"
