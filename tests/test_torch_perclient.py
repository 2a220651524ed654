"""Heterogeneous privacy and weighted aggregation in the port against the JAX
package, on the CPU.

``per_client_sigmas`` and ``PerClientGaussian``'s constants and budget
(float64 on the host, rtol 1e-12); ``WeightedAggregation``'s checks and row
weights; ``ldp-fedexp-perclient`` and other weighted compositions in dense
and sampled rounds, at uniform and mixed epsilons, fed the JAX round's own
unit-sigma noise (rtol 1e-5); sessions and their checks.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compose as jcomp  # noqa: E402
from repro.core import mechanisms as jmech  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro_torch.core import compose as tcomp  # noqa: E402
from repro_torch.core import mechanisms as tmech  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import CohortSpec, FederatedSession, TrainSpec  # noqa: E402
from test_torch_moments import (  # noqa: E402
    close,
    close_vec,
    deltas_for,
    round_noise_of,
)

M, D = 40, 24
TIERS = tuple([0.5] * 10 + [2.0] * 10 + [8.0] * 20)
EPSILONS = {"uniform": (2.0,) * M, "tiers": TIERS,
            "spread": tuple(float(e) for e in np.geomspace(0.2, 20.0, M))}


@pytest.mark.parametrize("delta", [1e-5, 1e-3])
@pytest.mark.parametrize("clip", [0.3, 3.0])
@pytest.mark.parametrize("kind", list(EPSILONS))
def test_per_client_sigmas_equal_jax(kind, clip, delta):
    got = tmech.per_client_sigmas(EPSILONS[kind], delta, clip)
    want = jmech.per_client_sigmas(EPSILONS[kind], delta, clip)
    assert isinstance(got, tuple) and len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_per_client_sigmas_refuse_what_jax_refuses():
    for bad in ((), (1.0, 0.0), (-1.0,)):
        with pytest.raises(ValueError) as jerr:
            jmech.per_client_sigmas(bad, 1e-5, 1.0)
        with pytest.raises(ValueError) as terr:
            tmech.per_client_sigmas(bad, 1e-5, 1.0)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind", list(EPSILONS))
def test_mechanism_constants_and_budget_equal_jax(kind):
    j = jcomp.PerClientGaussian(0.8, EPSILONS[kind], 1e-5)
    t = tcomp.PerClientGaussian(0.8, EPSILONS[kind], 1e-5)
    np.testing.assert_allclose(t.sigmas, j.sigmas, rtol=1e-12)
    np.testing.assert_allclose(t.inverse_variance_weights(), j.inverse_variance_weights(),
                               rtol=1e-12)
    assert t._uniform == j._uniform == (kind == "uniform")
    want = j.budget(1e-5, rounds=50, dim=D, sampling_q=0.1, with_numerator=True)
    got = t.budget(1e-5, rounds=50, dim=D, sampling_q=0.1, with_numerator=True)
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f)


def test_weighted_aggregation_checks_and_rows_equal_jax():
    for bad in ((), (1.0, -0.5), (0.0, 0.0)):
        with pytest.raises(ValueError) as jerr:
            jcomp.WeightedAggregation(bad)
        with pytest.raises(ValueError) as terr:
            tcomp.WeightedAggregation(bad)
        assert str(terr.value) == str(jerr.value)
    w = tuple(float(v) for v in np.random.default_rng(0).random(10) + 0.1)
    j, t = jcomp.WeightedAggregation(w), tcomp.WeightedAggregation(w)
    assert t.is_weighted and not tcomp.MeanAggregation().is_weighted
    assert tcomp.MeanAggregation().row_weights(0, 10, "cpu") is None
    slots = np.array([9, 2, 0, 0], np.int64)
    for jstart, tstart, m in ((0, 0, 10), (6, 6, 8),
                              (jnp.asarray(slots), torch.tensor(slots), 4)):
        np.testing.assert_array_equal(t.row_weights(tstart, m, "cpu").numpy(),
                                      np.asarray(j.row_weights(jstart, m)))


def _weighted_pair(mech_name, weights):
    """The same weighted composition in both packages."""
    build = {
        "gaussian": lambda p: p.GaussianLDP(1.0, 0.6),
        "central": lambda p: p.CentralGaussian(clip_norm=1.0, sigma=0.5, num_clients=M),
        "noprivacy": lambda p: p.NoPrivacy(),
        "privunit": lambda p: p.PrivUnitLDP(1.0, 2.0, 2.0, 2.0, D),
    }[mech_name]
    return tuple(p.ComposedAlgorithm(mechanism=build(p), step=p.FedEXPStep(),
                                     aggregation=p.WeightedAggregation(weights), name=mech_name)
                 for p in (jcomp, tcomp))


ROUNDS = [("perclient", k) for k in EPSILONS] + [(m, "weights") for m in
                                                 ("gaussian", "central", "noprivacy",
                                                  "privunit")]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("what,kind", ROUNDS)
def test_weighted_rounds_match_jax(what, kind, masked):
    """Dense (the moment route with a ones mask) and masked rounds."""
    rng = np.random.default_rng(7)
    if what == "perclient":
        kw = dict(clip_norm=1.0, epsilons=EPSILONS[kind], delta=1e-5)
        jalg, talg = jax_make("ldp-fedexp-perclient", **kw), make_algorithm(
            "ldp-fedexp-perclient", **kw)
    else:
        jalg, talg = _weighted_pair(what, tuple(float(v) for v in 0.2 + rng.random(M)))
    x = deltas_for(rng, M, D)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    noise = round_noise_of(jalg, key, M, D)
    jstate, tstate = jalg.init_state(jnp.asarray(w)), talg.init_state(torch.tensor(w))
    if masked:
        mask = (rng.random(M) < 0.4).astype(np.float32)
        x[mask == 0] = 0.0
        jm = jalg.local_moments(key, jnp.asarray(w), jnp.asarray(x), jnp.asarray(mask), 0,
                                jstate)
        tm = talg.local_moments(noise, torch.tensor(w), torch.tensor(x), torch.tensor(mask),
                                0, tstate)
        close(tm[1]["n_clients"], jm[1]["n_clients"], what="n_clients")
        jw, jaux, _ = jalg.apply_from_moments(key, jnp.asarray(w), jm, jstate)
        tw, taux, _ = talg.apply_from_moments(noise, torch.tensor(w), tm, tstate)
    else:
        jw, jaux, _ = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x), jstate)
        tw, taux, _ = talg.apply_round_stateful(None, torch.tensor(w), torch.tensor(x),
                                                tstate, noise)
    close(taux.eta_g, jaux.eta_g, what="eta_g")
    for f in ("eta_naive", "eta_target"):
        j, g = float(getattr(jaux, f)), float(getattr(taux, f))
        assert math.isnan(j) == math.isnan(g), f
        if not math.isnan(j):
            close(g, j, what=f)
    close_vec(tw.numpy(), jw)


@pytest.mark.parametrize("kind", ["uniform", "tiers"])
def test_unweighted_per_client_release_matches_jax(kind):
    """PerClientGaussian under the mean: the dense release with per-row sigmas
    (materialized noise) and, when uniform, GaussianLDP's expressions."""
    j = jcomp.ComposedAlgorithm(mechanism=jcomp.PerClientGaussian(1.0, EPSILONS[kind], 1e-5),
                                step=jcomp.FedEXPStep())
    t = tcomp.ComposedAlgorithm(mechanism=tcomp.PerClientGaussian(1.0, EPSILONS[kind], 1e-5),
                                step=tcomp.FedEXPStep())
    rng = np.random.default_rng(9)
    x, w = deltas_for(rng, M, D), (0.3 * rng.standard_normal(D)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jw, jaux = j.apply_round(key, jnp.asarray(w), jnp.asarray(x))
    tw, taux = t.apply_round(None, torch.tensor(w), torch.tensor(x),
                             round_noise_of(j, key, M, D))
    close(taux.eta_g, jaux.eta_g, what="eta_g")
    close_vec(tw.numpy(), jw)


def test_seeded_noise_of_the_port_is_per_client():
    """Without injected noise, row i's noise is client i's unit-sigma stream
    times sigma_i: the gathered block's release equals the dense one's rows."""
    mech = tcomp.PerClientGaussian(1.0, TIERS, 1e-5)
    alg = tcomp.ComposedAlgorithm(mechanism=mech, step=tcomp.FedEXPStep(),
                                  aggregation=tcomp.WeightedAggregation(
                                      mech.inverse_variance_weights()))
    noise = alg.draw_noise(round_generator(1, 0), M, D, "cpu")
    x = torch.tensor(deltas_for(np.random.default_rng(2), M, D))
    slots = torch.tensor([3, 12, 25, 39, 0])
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    dense_mask = torch.zeros(M)
    dense_mask[slots[:4]] = 1.0
    w = torch.zeros(D)
    a = alg.local_moments(noise, w, x[slots] * mask[:, None], mask, slots, ())
    b = alg.local_moments(noise, w, x * dense_mask[:, None], dense_mask, 0, ())
    close_vec(a[0].sum_c.numpy(), b[0].sum_c.numpy())
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(a[0], f), getattr(b[0], f), what=f)
    for k in ("sum_sigma_sq", "n_clients"):
        close(a[1][k], b[1][k], what=k)


def _session(data, epsilons, cohort=None, rounds=3):
    return FederatedSession(
        make_algorithm("ldp-fedexp-perclient", clip_norm=1.0, epsilons=epsilons, delta=1e-5),
        linreg_loss, np.zeros(D, np.float32), data, cohort=cohort,
        train=TrainSpec(rounds=rounds, tau=3, eta_l=0.1), device="cpu")


def test_sessions_run_and_refuse_tables_of_another_length():
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((M, D)).astype(np.float32),
            "y": rng.standard_normal(M).astype(np.float32)}
    for cohort in (None, CohortSpec(q=0.3), CohortSpec(q=0.3, gather=True)):
        r = _session(data, TIERS, cohort).run(0)
        assert torch.isfinite(r.final_w).all() and bool((r.eta_history >= 1.0).all())
    with pytest.raises(ValueError, match="39 weights for a 40-client cohort"):
        _session(data, TIERS[:39])
    for alg, msg in (
            (tcomp.ComposedAlgorithm(mechanism=tcomp.GaussianLDP(1.0, 0.5),
                                     step=tcomp.FixedEta(),
                                     aggregation=tcomp.WeightedAggregation((1.0,) * 41)),
             "41 weights for a 40-client cohort"),
            (tcomp.ComposedAlgorithm(mechanism=tcomp.PerClientGaussian(1.0, TIERS[:39], 1e-5),
                                     step=tcomp.FedEXPStep()),
             "39 per-client epsilons for a 40-client cohort")):
        with pytest.raises(ValueError, match=msg):
            FederatedSession(alg, linreg_loss, np.zeros(D, np.float32), data,
                             train=TrainSpec(rounds=1, tau=1, eta_l=0.1), device="cpu")
    rep = _session(data, TIERS, CohortSpec(q=0.1)).privacy_report(1e-5)
    assert rep.setting == "LDP (Gaussian, per-client worst of 40)"
