"""The port's PrivUnit (mechanisms, PrivUnitLDP, the two registry names)
against the JAX package's, on the CPU.

The port does not reproduce JAX's random streams, so module parity reads
JAX's own draws: each client's key is split as ``privunit_randomize``,
``privunit_direction`` and ``scalardp_magnitude`` split it, and the uniforms,
normals and integers drawn on those keys go to the port's functions.  Float64
constants are held at rtol 1e-12; releases and ``estimate_norm_sq`` at rtol
1e-5 (a vector's atol 1e-5 times its largest entry) at d <= 500.  At d =
131072 the JAX package's float32 bisection of betainc is the less accurate
side: the port's quantiles are held to scipy's float64 ``betaincinv`` (and
to the module's own float64 ``_betainc_f64``) at 1e-9, and their gap to
JAX's is printed (``-s``).  Noisy sessions are held statistically.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy.special import betaincinv  # noqa: E402

from repro.core import mechanisms as jmech  # noqa: E402
from repro.core.algorithm import client_keys  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro_torch.core import mechanisms as tmech  # noqa: E402
from repro_torch.core.algorithm import RoundNoise  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import FederatedSession, TrainSpec  # noqa: E402

EPS = dict(eps0=2.0, eps1=2.0, eps2=2.0)
HP = {"ldp-fedexp-privunit": (0.1, 1.0), "dp-fedavg-privunit": (0.3, 3.0)}  # (eta_l, C)


def _close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def jax_draws(keys, d, k):
    """Per client the six draws of ``privunit_randomize`` on its key, as numpy."""
    def one(key):
        k_dir, k_mag = jax.random.split(key)
        k_cap, k_t, k_w = jax.random.split(k_dir, 3)
        k_round, k_rr, k_unif = jax.random.split(k_mag, 3)
        return (jax.random.uniform(k_cap), jax.random.uniform(k_t),
                jax.random.normal(k_w, (d,), jnp.float32), jax.random.uniform(k_round),
                jax.random.uniform(k_rr), jax.random.randint(k_unif, (), 0, k))
    names = ("cap_u", "u01", "g", "round_u", "keep_u", "u_int")
    return {n: np.asarray(v) for n, v in zip(names, jax.vmap(one)(keys))}


def noise_of(draws) -> RoundNoise:
    return RoundNoise(**{k: torch.tensor(v) for k, v in draws.items()})


def _deltas(rng, m, d, c):
    """Rows with norms spread over [0, 2C], so that about half clip at C."""
    x = rng.standard_normal((m, d)).astype(np.float32)
    x *= (2 * c * rng.random((m, 1)) / np.linalg.norm(x, axis=1, keepdims=True))
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,eps0,eps1", [(100, 2.0, 2.0), (500, 2.0, 2.0), (32, 2.0, 2.0),
                                         (131072, 2.0, 2.0), (1000, 1.0, 3.0), (20, 4.0, 0.5)])
def test_privunit_params_equal_jax(d, eps0, eps1):
    got, want = tmech.make_privunit_params(d, eps0, eps1), jmech.make_privunit_params(d, eps0,
                                                                                      eps1)
    for f in ("dim", "eps0", "eps1", "p", "gamma", "m", "alpha", "tau", "i_tau"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(tmech._betainc_f64(want.alpha, want.alpha, 0.5 + 0.1 / d),
                               jmech._betainc_f64(want.alpha, want.alpha, 0.5 + 0.1 / d),
                               rtol=1e-12)


@pytest.mark.parametrize("eps2,r_max", [(2.0, 1.0), (2.0, 3.0), (2.0, 0.3), (1.0, 0.5),
                                        (6.0, 2.0)])
def test_scalardp_params_equal_jax(eps2, r_max):
    got, want = tmech.make_scalardp_params(eps2, r_max), jmech.make_scalardp_params(eps2, r_max)
    for f in ("eps2", "r_max", "k", "a", "b", "c1", "c2", "c3"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)


def test_params_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="d >= 2"):
        tmech.make_privunit_params(1, 2.0, 2.0)
    with pytest.raises(ValueError) as jerr:
        jmech.make_privunit_params(10_000_000, 0.0, 1e-6)
    with pytest.raises(ValueError) as terr:
        tmech.make_privunit_params(10_000_000, 0.0, 1e-6)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the randomizers on JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [100, 500])
@pytest.mark.parametrize("c", [1.0, 3.0])
def test_privunit_randomize_matches_jax_on_its_draws(d, c):
    m = 48
    pu, sc = jmech.make_privunit_params(d, 2.0, 2.0), jmech.make_scalardp_params(2.0, c)
    tpu, tsc = tmech.make_privunit_params(d, 2.0, 2.0), tmech.make_scalardp_params(2.0, c)
    rng = np.random.default_rng(d)
    x = _deltas(rng, m, d, c)
    x = x * np.minimum(1.0, c / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(d + int(10 * c)), m)
    want = np.asarray(jax.vmap(lambda k, v: jmech.privunit_randomize(k, v, pu, sc))(
        keys, jnp.asarray(x)))
    dr = jax_draws(keys, d, sc.k)
    t = tmech.privunit_quantile(dr["cap_u"], dr["u01"], tpu).to(torch.float32)
    got = tmech.privunit_randomize(torch.tensor(x), t, torch.tensor(dr["g"]),
                                   torch.tensor(dr["round_u"]), torch.tensor(dr["keep_u"]),
                                   torch.tensor(dr["u_int"]), tpu, tsc)
    for i in range(m):
        _close_vec(got[i].numpy(), want[i])
    # the magnitude alone is the same function of the same draws: equal
    nrm = torch.linalg.vector_norm(torch.tensor(x), dim=-1)
    r_got = tmech.scalardp_magnitude(nrm, torch.tensor(dr["round_u"]),
                                     torch.tensor(dr["keep_u"]), torch.tensor(dr["u_int"]), tsc)
    r_want = np.asarray(jax.vmap(lambda k, r: jmech.scalardp_magnitude(
        jax.random.split(k)[1], r, sc))(keys, jnp.asarray(nrm.numpy())))
    np.testing.assert_allclose(r_got.numpy(), r_want, rtol=1e-6)
    # the direction has norm 1/m
    unit = torch.tensor(x) / nrm[:, None]
    z = tmech.privunit_direction(unit, t, torch.tensor(dr["g"]), tpu)
    np.testing.assert_allclose(torch.linalg.vector_norm(z, dim=-1).numpy(), 1.0 / tpu.m,
                               rtol=1e-5)
    # Algorithm 4 on the release: the port on its own release, and on JAX's
    s_want = np.asarray(jax.vmap(lambda v: jmech.estimate_norm_sq(v, pu, sc))(jnp.asarray(want)))
    np.testing.assert_allclose(tmech.estimate_norm_sq(got, tpu, tsc).numpy(), s_want, rtol=1e-5)
    np.testing.assert_allclose(tmech.estimate_norm_sq(torch.tensor(want), tpu, tsc).numpy(),
                               s_want, rtol=1e-5)


@pytest.mark.parametrize("c", [0.3, 1.0, 3.0])
def test_estimate_norm_sq_sign_agrees_with_jax_at_the_paper_clips(c):
    """The lattice test decides the sign in float32 by the distance to an
    integer: on 512 releases at each of the paper's clip values, no sign
    differs from the JAX package's (s_hat would change value, not by a
    rounding)."""
    m, d = 512, 100
    pu, sc = jmech.make_privunit_params(d, 2.0, 2.0), jmech.make_scalardp_params(2.0, c)
    tpu, tsc = tmech.make_privunit_params(d, 2.0, 2.0), tmech.make_scalardp_params(2.0, c)
    x = _deltas(np.random.default_rng(7), m, d, c)
    x = x * np.minimum(1.0, c / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), m)
    rel = np.asarray(jax.vmap(lambda k, v: jmech.privunit_randomize(k, v, pu, sc))(
        keys, jnp.asarray(x)))
    s_want = np.asarray(jax.vmap(lambda v: jmech.estimate_norm_sq(v, pu, sc))(jnp.asarray(rel)))
    s_got = tmech.estimate_norm_sq(torch.tensor(rel), tpu, tsc).numpy()
    # s(+r) - s(-r) = -2 c2 r / (1 + c1) > 0: the sign each package chose
    r = pu.m * np.linalg.norm(rel.astype(np.float64), axis=1)
    mid = (r * r - sc.c3) / (1 + sc.c1)
    assert np.array_equal(s_got > mid, s_want > mid)
    assert 0 < np.sum(s_want > mid) < m          # both signs occur
    np.testing.assert_allclose(s_got, s_want, rtol=1e-5)


def test_quantiles_at_full_size_hold_to_float64_and_print_the_gap_to_jax():
    d, m = 131072, 16
    pu = jmech.make_privunit_params(d, 2.0, 2.0)
    tpu = tmech.make_privunit_params(d, 2.0, 2.0)
    keys = jax.random.split(jax.random.PRNGKey(11), m)
    dr = jax_draws(keys, 2, 2)   # only the two uniforms are read here
    t = tmech.privunit_quantile(dr["cap_u"], dr["u01"], tpu).numpy()
    cap = dr["cap_u"] < np.float32(pu.p)
    u01 = dr["u01"].astype(np.float64)
    y = np.where(cap, pu.i_tau + u01 * (1 - pu.i_tau), u01 * pu.i_tau)
    x_ref = betaincinv(pu.alpha, pu.alpha, y)
    np.testing.assert_allclose((1 + t) / 2, x_ref, rtol=1e-9, atol=0)
    # and against the module's own float64 continued fraction, independent of scipy
    back = np.array([tmech._betainc_f64(pu.alpha, pu.alpha, xi) for xi in (1 + t) / 2])
    np.testing.assert_allclose(back, y, rtol=1e-9, atol=0)
    x_jax = np.asarray(jax.vmap(lambda yy: jmech._betainc_inv_bisect(pu.alpha, yy))(
        jnp.asarray(y, jnp.float32)), np.float64)
    gap = np.abs(x_jax - x_ref)
    rel_t = gap / np.abs(2 * x_ref - 1)
    print(f"\nd={d}: JAX's float32 bisection against float64: max |dx| {gap.max():.3e}, "
          f"max |dt|/|t| {rel_t.max():.3e} (t = 2x - 1, |t| >= {np.abs(2 * x_ref - 1).min():.2e})")
    assert gap.max() < 1e-4       # the size the float32 bisection reaches, not more


# ---------------------------------------------------------------------------
# PrivUnitLDP and the registry names
# ---------------------------------------------------------------------------

def _release_inputs(name, m, d, c, seed):
    kw = dict(clip_norm=c, dim=d, **EPS)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    x = _deltas(np.random.default_rng(seed), m, d, c)
    key = jax.random.PRNGKey(seed)
    return jalg, talg, x, key


@pytest.mark.parametrize("clip_override", [None, 0.7])
def test_mechanism_release_matches_jax(clip_override):
    m, d, c = 40, 100, 1.0
    jalg, talg, x, key = _release_inputs("ldp-fedexp-privunit", m, d, c, 5)
    jclip = None if clip_override is None else jnp.float32(clip_override)
    tclip = None if clip_override is None else torch.tensor(clip_override)
    jstats, jextras = jalg.mechanism.release(key, jnp.asarray(x), jclip, float(m))
    noise = noise_of(jax_draws(client_keys(key, m, 0), d, jalg.mechanism.sc.k))
    tstats, textras = talg.mechanism.release(noise, torch.tensor(x), tclip)
    _close_vec(tstats.cbar.numpy(), jstats.cbar)
    for f in ("mean_sq", "agg_sq", "mean_sq_clipped"):
        np.testing.assert_allclose(float(getattr(tstats, f)), float(getattr(jstats, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(float(textras["mean_s_hat"]), float(jextras["mean_s_hat"]),
                               rtol=1e-5)


@pytest.mark.parametrize("name", list(HP))
def test_round_matches_jax_on_its_draws(name):
    m, d, c = 40, 100, HP[name][1]
    jalg, talg, x, key = _release_inputs(name, m, d, c, 9)
    w = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    jw, jaux, _ = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x), ())
    noise = noise_of(jax_draws(client_keys(key, m, 0), d, jalg.mechanism.sc.k))
    tw, taux = talg.apply_round(None, torch.tensor(w), torch.tensor(x), noise)
    for f in ("eta_g", "eta_naive", "eta_target"):
        j, t = float(getattr(jaux, f)), float(getattr(taux, f))
        assert math.isnan(j) == math.isnan(t), f
        if not math.isnan(j):
            np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=f)
    _close_vec(tw.numpy(), jw)


def test_registry_budget_and_draws():
    kw = dict(clip_norm=1.0, dim=32, **EPS)
    for name in HP:
        alg, jalg = make_algorithm(name, **kw), jax_make(name, **kw)
        got, want = alg.budget(1e-5, rounds=7, dim=32), jalg.budget(1e-5, rounds=7, dim=32)
        assert got.setting == want.setting == "LDP (PrivUnit)"
        assert got.eps_numerical == want.eps_numerical == 6.0
        assert alg.mechanism.clip_independent_budget
    from repro_torch.core.algorithm import round_generator
    alg = make_algorithm("ldp-fedexp-privunit", **kw)
    a = alg.draw_noise(round_generator(2, 0), 10, 32, "cpu")
    b = alg.draw_noise(round_generator(2, 0), 10, 32, "cpu")
    assert a.u_int.dtype == torch.int32
    assert 0 <= int(a.u_int.min()) and int(a.u_int.max()) < alg.mechanism.sc.k
    for f in ("cap_u", "u01", "round_u", "keep_u", "u_int"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # the directions' normal is keyed by (seed, client, column), not drawn (M, d)
    assert a.xi is None and a.g is None and isinstance(a.seed, int) and a.seed == b.seed
    from repro_torch.kernels.dp_aggregate.ref import ldp_noise_ref
    g = alg.mechanism._normal(a, (10, 32), 0, "cpu")
    assert g.shape == (10, 32) and torch.equal(g, ldp_noise_ref(10, 32, a.seed, 1.0))


M, D, TAU, ROUNDS = 40, 32, 5, 5


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def _sessions(name, data):
    eta_l, c = HP[name]
    kw = dict(clip_norm=c, dim=D, **EPS)
    js = JaxSession(jax_make(name, **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=eta_l))
    ts = FederatedSession(make_algorithm(name, **kw), linreg_loss, np.zeros(D, np.float32),
                          {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=eta_l), device="cpu")
    return js, ts


@pytest.mark.parametrize("name", list(HP))
def test_sessions_agree_with_jax_in_distribution(name, data):
    """The packages draw different numbers; over 8 seeds each, the mean final
    ||w - w*|| and the mean eta_g must agree within 4 standard errors of the
    difference, and a seed repeats its run."""
    js, ts = _sessions(name, data)
    ws, seeds = data["w_star"], range(8)
    jr = [js.run(jax.random.PRNGKey(s)) for s in seeds]
    tr = [ts.run(s) for s in seeds]
    for what, jv, tv in (
            ("final distance", [np.linalg.norm(np.asarray(r.final_w) - ws) for r in jr],
             [np.linalg.norm(r.final_w.numpy() - ws) for r in tr]),
            ("mean eta_g", [float(np.mean(r.eta_history)) for r in jr],
             [float(r.eta_history.mean()) for r in tr])):
        jv, tv = np.array(jv), np.array(tv)
        assert np.all(np.isfinite(tv)), what
        se = math.sqrt(jv.var(ddof=1) / len(jv) + tv.var(ddof=1) / len(tv))
        assert abs(jv.mean() - tv.mean()) <= 4 * se + 1e-6, (what, jv.mean(), tv.mean(), se)
    again = ts.run(0)
    assert torch.equal(again.final_w, tr[0].final_w)
    assert not torch.equal(tr[1].final_w, tr[0].final_w)
