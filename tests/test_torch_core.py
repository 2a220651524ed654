"""The port's core modules against the JAX package's, on the CPU.

Inputs are numpy arrays from fixed seeds handed to both packages.  Float32
results are held at rtol 1e-5; a vector's atol is 1e-5 times its largest
entry, since single entries can cancel to near zero.  The accounting is
float64 Python in both packages and is held at rtol 1e-12.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import accounting as jacc  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import clipping as jclip  # noqa: E402
from repro.core import stepsize as jstep  # noqa: E402
from repro.core.fedexp import list_algorithms as jax_list  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.fedsim.local import cohort_updates as jax_cohort  # noqa: E402
from repro_torch.core import accounting as tacc  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import clipping as tclip  # noqa: E402
from repro_torch.core import stepsize as tstep  # noqa: E402
from repro_torch.core.algorithm import RoundNoise, set_moment_count  # noqa: E402
from repro_torch.core.compose import (  # noqa: E402
    CentralGaussian,
    ComposedAlgorithm,
    FedEXPStep,
    compose_algorithm,
)
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim.local import cohort_updates  # noqa: E402

NAMES = ["fedavg", "fedexp", "dp-fedavg-ldp-gauss", "ldp-fedexp-gauss",
         "dp-fedavg-cdp", "cdp-fedexp"]
# every name the port builds: the six above, PrivUnit, server optimizers,
# adaptive clipping and noise schedules
PORTED = NAMES + ["dp-fedavg-privunit", "ldp-fedexp-privunit", "privunit-fedexp-adaptive-clip",
                  "cdp-fedexp-adaptive-clip", "dp-fedadam-cdp", "ldp-gauss-fedadam",
                  "cdp-fedmom", "ldp-fedexp-schedule", "cdp-fedexp-schedule",
                  "ldp-fedexp-perclient", "dp-scaffold"]


def _close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kwargs(name, m, clip=2.0):
    if name in ("fedavg", "fedexp"):
        return {}
    if "cdp" in name:
        return dict(clip_norm=clip, sigma=5 * clip / math.sqrt(m), num_clients=m)
    return dict(clip_norm=clip, sigma=0.7 * clip)


class TestClippingAndSteps:
    def test_clipping(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((12, 20)).astype(np.float32)
        x[3] = 0.0
        for c in (0.1, 1.0, 100.0):
            _close_vec(tclip.clip_batch(torch.tensor(x), c).numpy(),
                       jclip.clip_batch(jnp.asarray(x), c))
            _close_vec(tclip.clip_by_l2(torch.tensor(x[0]), c).numpy(),
                       jclip.clip_by_l2(jnp.asarray(x[0]), c))
        tree = {"W": x[:4], "b": x[5], "z": [x[6], x[7:9]]}
        want = float(jclip.global_l2_norm_tree(jax.tree_util.tree_map(jnp.asarray, tree)))
        got = float(tclip.global_l2_norm_tree(
            {"W": torch.tensor(x[:4]), "b": torch.tensor(x[5]),
             "z": [torch.tensor(x[6]), torch.tensor(x[7:9])]}))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    @pytest.mark.parametrize("mean_sq,agg_sq", [(0.34, 0.014), (2.0, 3.0), (1e-3, 1e-13),
                                                (5.0, 0.0)])
    def test_every_stepsize_rule(self, mean_sq, agg_sq):
        a, b = np.float32(mean_sq), np.float32(agg_sq)
        ja, jb = jnp.float32(a), jnp.float32(b)
        ta, tb = torch.tensor(a), torch.tensor(b)
        pairs = [
            (tstep.fedavg(), jstep.fedavg()),
            (tstep.fedexp(ta, tb), jstep.fedexp(ja, jb)),
            (tstep.naive_noisy(ta, tb), jstep.naive_noisy(ja, jb)),
            (tstep.target(ta, tb), jstep.target(ja, jb)),
            (tstep.ldp_gaussian(ta, tb, 30, 0.05), jstep.ldp_gaussian(ja, jb, 30, 0.05)),
            (tstep.ldp_gaussian_mixed(ta, tb, 30, 0.004),
             jstep.ldp_gaussian_mixed(ja, jb, 30, 0.004)),
            (tstep.ldp_privunit(ta, tb), jstep.ldp_privunit(ja, jb)),
            (tstep.cdp(ta, torch.tensor(np.float32(-0.01)), tb),
             jstep.cdp(ja, jnp.float32(-0.01), jb)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_fedexp_on_identical_rows_is_one_up_to_rounding(self):
        """f32 rounding puts the ratio a hair above 1 (1.0000012 in the JAX
        package), so the rule's output is held approximately, not exactly."""
        rows = np.tile(np.linspace(-1, 1, 33, dtype=np.float32), (50, 1))
        want = jagg.aggregate_stats(jnp.asarray(rows))
        got = tagg.aggregate_stats(torch.tensor(rows))
        eta_t = float(tstep.fedexp(got.mean_sq, got.agg_sq))
        eta_j = float(jstep.fedexp(want.mean_sq, want.agg_sq))
        assert 1.0 <= eta_t < 1.0 + 1e-5
        np.testing.assert_allclose(eta_t, eta_j, rtol=1e-5)


class TestAccounting:
    DELTAS = (1e-5, 1e-3)

    @pytest.mark.parametrize("mu", [0.05, 0.5, 1.0, 3.0, 12.0])
    def test_gdp_curve(self, mu):
        for delta in self.DELTAS:
            np.testing.assert_allclose(tacc.gdp_epsilon(mu, delta), jacc.gdp_epsilon(mu, delta),
                                       rtol=1e-12)
            np.testing.assert_allclose(tacc.gdp_delta(mu, 1.0), jacc.gdp_delta(mu, 1.0),
                                       rtol=1e-12)
            np.testing.assert_allclose(tacc.gaussian_rdp_epsilon(mu, delta),
                                       jacc.gaussian_rdp_epsilon(mu, delta), rtol=1e-12)

    @pytest.mark.parametrize("eps", [0.1, 1.0, 4.0, 16.0])
    def test_inverses(self, eps):
        for delta in self.DELTAS:
            np.testing.assert_allclose(tacc.gdp_mu_for_epsilon(eps, delta),
                                       jacc.gdp_mu_for_epsilon(eps, delta), rtol=1e-12)
            np.testing.assert_allclose(tacc.sigma_for_epsilon(eps, delta, 0.6),
                                       jacc.sigma_for_epsilon(eps, delta, 0.6), rtol=1e-12)

    @pytest.mark.parametrize("q", [1.0, 0.3, 0.01])
    def test_composition_and_budgets(self, q):
        np.testing.assert_allclose(tacc.subsampled_gdp_mu(0.4, q, 50),
                                   jacc.subsampled_gdp_mu(0.4, q, 50), rtol=1e-12)
        mus = (0.1, 0.4, 0.2)
        np.testing.assert_allclose(tacc.composed_gdp_mu(mus, q), jacc.composed_gdp_mu(mus, q),
                                   rtol=1e-12)
        assert tacc.realized_participation(q, 0.2) == jacc.realized_participation(q, 0.2)
        pairs = [
            (tacc.cdp_budget(0.3, 0.05, 1000, 50, 1e-5, sigma_xi=0.1, sampling_q=q),
             jacc.cdp_budget(0.3, 0.05, 1000, 50, 1e-5, sigma_xi=0.1, sampling_q=q)),
            (tacc.cdp_budget(3.0, 0.5, 1000, 50, 1e-5, sampling_q=q),
             jacc.cdp_budget(3.0, 0.5, 1000, 50, 1e-5, sampling_q=q)),
            (tacc.ldp_gaussian_budget(0.3, 0.21, 1e-5), jacc.ldp_gaussian_budget(0.3, 0.21, 1e-5)),
            (tacc.schedule_ldp_budget(0.3, (0.2, 0.3), 1e-5),
             jacc.schedule_ldp_budget(0.3, (0.2, 0.3), 1e-5)),
            (tacc.schedule_cdp_budget(0.3, (0.05, 0.06), 1000, 1e-5, (0.1, 0.2), q),
             jacc.schedule_cdp_budget(0.3, (0.05, 0.06), 1000, 1e-5, (0.1, 0.2), q)),
            (tacc.privunit_budget(2.0, 2.0, 2.0), jacc.privunit_budget(2.0, 2.0, 2.0)),
        ]
        for got, want in pairs:
            assert got.setting == want.setting
            for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
                np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12,
                                           err_msg=f)


class TestAggregationAndLocal:
    def test_aggregate_stats_and_moments(self):
        rng = np.random.default_rng(4)
        u = rng.standard_normal((30, 17)).astype(np.float32)
        want, got = jagg.aggregate_stats(jnp.asarray(u)), tagg.aggregate_stats(torch.tensor(u))
        _close_vec(got.cbar.numpy(), want.cbar)
        np.testing.assert_allclose(float(got.mean_sq), float(want.mean_sq), rtol=1e-5)
        np.testing.assert_allclose(float(got.agg_sq), float(want.agg_sq), rtol=1e-5)
        s = u.sum(0)
        jm = jagg.RoundMoments(jnp.asarray(s), jnp.float32(9.0), jnp.float32(4.0),
                               jnp.float32(30.0)).stats()
        tm = set_moment_count(tagg.RoundMoments(torch.tensor(s), torch.tensor(9.0),
                                                torch.tensor(4.0), torch.tensor(7.0)), 30).stats()
        _close_vec(tm.cbar.numpy(), jm.cbar)
        for f in ("mean_sq", "agg_sq", "mean_sq_clipped"):
            np.testing.assert_allclose(float(getattr(tm, f)), float(getattr(jm, f)), rtol=1e-6)

    def test_cohort_updates(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((8, 16)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        y = (x @ rng.standard_normal(16)).astype(np.float32)
        w = (0.1 * rng.standard_normal(16)).astype(np.float32)
        want = jax_cohort(jax_loss, jnp.asarray(w), {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                          5, 0.3)
        got = cohort_updates(linreg_loss, torch.tensor(w),
                             {"x": torch.tensor(x), "y": torch.tensor(y)}, 5, 0.3)
        assert got.shape == (8, 16)
        _close_vec(got.numpy(), want)


class TestDenseRound:
    """One dense round of each name with the JAX round's own noise injected."""

    M, D = 40, 32

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("name", NAMES)
    def test_round_matches_jax_with_injected_noise(self, name, seed):
        from repro.core.aggregation import materialize_ldp_noise
        m, d = self.M, self.D
        rng = np.random.default_rng(seed)
        deltas = (0.3 * rng.standard_normal((m, d)) + 0.1).astype(np.float32)
        w = rng.standard_normal(d).astype(np.float32)
        kw = _kwargs(name, m)
        jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)

        key = jax.random.PRNGKey(100 + seed)
        jw, jaux, _ = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(deltas),
                                                jalg.init_state(jnp.asarray(w)))
        k_mech, extra = jalg._split_keys(key)
        noise = RoundNoise()
        if "ldp" in name:
            noise.ldp = torch.tensor(np.asarray(materialize_ldp_noise(k_mech, m, d, kw["sigma"])))
        if "cdp" in name:
            noise.central = torch.tensor(np.asarray(jax.random.normal(k_mech, (d,))))
            if extra:
                noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
        tw, taux = talg.apply_round(None, torch.tensor(w), torch.tensor(deltas), noise)

        np.testing.assert_allclose(float(taux.eta_g), float(jaux.eta_g), rtol=1e-5)
        for f in ("eta_naive", "eta_target", "update_norm"):
            j, t = float(getattr(jaux, f)), float(getattr(taux, f))
            assert math.isnan(j) == math.isnan(t), f
            if not math.isnan(j):
                np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=f)
        _close_vec(tw.numpy(), jw)

    def test_round_draws_are_deterministic_per_generator(self):
        from repro_torch.core.algorithm import round_generator
        alg = make_algorithm("cdp-fedexp", **_kwargs("cdp-fedexp", self.M))
        a = alg.draw_noise(round_generator(3, 1), self.M, self.D, "cpu")
        b = alg.draw_noise(round_generator(3, 1), self.M, self.D, "cpu")
        c = alg.draw_noise(round_generator(3, 2), self.M, self.D, "cpu")
        assert torch.equal(a.central, b.central) and torch.equal(a.xi, b.xi)
        assert not torch.equal(a.central, c.central)
        ldp = make_algorithm("ldp-fedexp-gauss", **_kwargs("ldp-fedexp-gauss", self.M))
        s = ldp.draw_noise(round_generator(3, 1), self.M, self.D, "cpu").seed
        assert 0 <= s < 2**32


class TestRegistry:
    def test_names(self):
        assert list_algorithms() == sorted(PORTED)
        assert set(PORTED) <= set(jax_list())

    def test_later_names_raise_not_implemented(self):
        # nothing is left to port: the registry is the JAX registry's 17 names,
        # and dp-scaffold, the last of them, builds
        assert list_algorithms() == sorted(jax_list()) and len(list_algorithms()) == 17
        alg = make_algorithm("dp-scaffold", clip_norm=1.0, sigma=1.0, central=True,
                             num_clients=10, tau=5, eta_l=0.3)
        assert alg.name == "dp-scaffold" and alg.uses_local_context
        with pytest.raises(KeyError, match="unknown algorithm"):
            make_algorithm("no-such-name")

    def test_composition_surface(self):
        alg = make_algorithm("cdp-fedexp", **_kwargs("cdp-fedexp", 10))
        assert isinstance(alg, ComposedAlgorithm) and alg.is_private
        assert alg.sigma_xi is None and alg.num_clients == 10   # forwarded to the mechanism
        assert not make_algorithm("fedexp").is_private
        c = compose_algorithm(CentralGaussian(clip_norm=1.0, sigma=0.1, num_clients=5),
                              FedEXPStep())
        assert c.name == "centralgaussian-fedexpstep"
        with pytest.raises(ValueError, match="not a private algorithm"):
            make_algorithm("fedavg").budget(1e-5, rounds=3, dim=4)
        with pytest.raises(ValueError, match="exactly one of sigma"):
            CentralGaussian(num_clients=5)
