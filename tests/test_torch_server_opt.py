"""The port's server optimizers (repro_torch.optim, ServerOpt) and noise
schedules (NoiseSchedule) against the JAX package's, on the CPU.

Optimizer updates and deterministic sessions (sigma = 0) are held at rtol
1e-5 (a vector's atol 1e-5 times its largest entry); rounds with noise read
JAX's own draws.  sigma(t) is held within 4 float32 ulps of JAX's traced
value (the two packages' float32 powers differ by up to 2 ulps) and the
float64 ``sigma_value`` and budget reports at rtol 1e-12.  FedEXP sessions
are compared at eta_l 0.3, where float32 rounding does not move eta by 1e-5
(test_torch_session.py says why eta_l 0.1 is not).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core.aggregation import materialize_ldp_noise  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core.algorithm import RoundNoise, round_generator  # noqa: E402
from repro_torch.core.compose import (  # noqa: E402
    CentralGaussian,
    GaussianLDP,
    NoiseSchedule,
    PrivUnitLDP,
    ServerOpt,
)
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import FederatedSession, TrainSpec  # noqa: E402


def _close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = {
    "sgd": (lambda: joptim.sgd(0.7), lambda: toptim.sgd(0.7)),
    "momentum": (lambda: joptim.momentum(1.0, 0.9), lambda: toptim.momentum(1.0, 0.9)),
    "adam": (lambda: joptim.adam(0.1), lambda: toptim.adam(0.1)),
    "adam-custom": (lambda: joptim.adam(0.03, 0.8, 0.99, 1e-6),
                    lambda: toptim.adam(0.03, 0.8, 0.99, 1e-6)),
}


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("tree", [False, True])
def test_optimizer_steps_match_jax(opt, tree):
    rng = np.random.default_rng(len(opt))
    shapes = {"W": (3, 5), "b": (4,)} if tree else {"w": (40,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if not tree:
        params = params["w"]
    jopt, topt = OPTS[opt][0](), OPTS[opt][1]()
    jmap = jax.tree_util.tree_map
    jp, tp = jmap(jnp.asarray, params), (
        {k: torch.tensor(v) for k, v in params.items()} if tree else torch.tensor(params))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(12):
        g = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** (step % 3 - 1)
             for k, s in shapes.items()}
        if not tree:
            g = g["w"]
        jstep, js = jopt.update(jmap(jnp.asarray, g), js)
        tstep, ts = topt.update({k: torch.tensor(v) for k, v in g.items()} if tree
                                else torch.tensor(g), ts)
        jp, tp = joptim.apply_update(jp, jstep), toptim.apply_update(tp, tstep)
        for jl, tl in zip(jax.tree_util.tree_leaves(jp),
                          [tp[k] for k in sorted(tp)] if tree else [tp]):
            _close_vec(tl.numpy(), jl)
    if opt.startswith("adam"):
        assert ts[2].dtype == torch.int32 and int(ts[2]) == 12


def test_server_opt_kinds():
    with pytest.raises(ValueError, match="unknown ServerOpt kind"):
        ServerOpt(kind="lion")
    assert ServerOpt(kind="momentum").stateful


# ---------------------------------------------------------------------------
# registry names with server optimizers
# ---------------------------------------------------------------------------

M, D, TAU, ROUNDS = 40, 32, 5, 5
SIGMA = {"dp-fedadam-cdp": lambda c: 5 * c / math.sqrt(M),
         "cdp-fedmom": lambda c: 5 * c / math.sqrt(M),
         "ldp-gauss-fedadam": lambda c: 0.7 * c,
         "ldp-fedexp-schedule": lambda c: 0.7 * c,
         "cdp-fedexp-schedule": lambda c: 5 * c / math.sqrt(M)}


def _kwargs(name, c=1.0, sigma_scale=1.0, **extra):
    kw = dict(clip_norm=c, sigma=sigma_scale * SIGMA[name](c), **extra)
    if "cdp" in name:
        kw["num_clients"] = M
    return kw


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def _sessions(name, data, eta_l=0.1, rounds=ROUNDS, **kw):
    js = JaxSession(jax_make(name, **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=rounds, tau=TAU, eta_l=eta_l))
    ts = FederatedSession(make_algorithm(name, **kw), linreg_loss, np.zeros(D, np.float32),
                          {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=rounds, tau=TAU, eta_l=eta_l), device="cpu")
    return js, ts


@pytest.mark.parametrize("name,extra", [("dp-fedadam-cdp", {}),
                                        ("dp-fedadam-cdp", {"server_lr": 0.03}),
                                        ("cdp-fedmom", {}),
                                        ("cdp-fedmom", {"server_lr": 0.5, "server_beta": 0.7}),
                                        ("ldp-gauss-fedadam", {})])
def test_deterministic_sessions_match_jax(name, extra, data):
    """sigma = 0: no noise anywhere; the runs are functions of the data."""
    js, ts = _sessions(name, data, **_kwargs(name, sigma_scale=0.0, **extra))
    jr, tr = js.run(jax.random.PRNGKey(1)), ts.run(1)
    np.testing.assert_allclose(tr.eta_history.numpy(), np.asarray(jr.eta_history), rtol=1e-6)
    _close_vec(tr.final_w.numpy(), jr.final_w)
    _close_vec(tr.last_w.numpy(), jr.last_w)


@pytest.mark.parametrize("name", ["dp-fedadam-cdp", "ldp-gauss-fedadam", "cdp-fedmom"])
def test_chained_noisy_rounds_match_jax_on_its_draws(name):
    m, d = 40, 64
    kw = _kwargs(name)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    w = np.zeros(d, np.float32)
    jw, jstate = jnp.asarray(w), jalg.init_state(jnp.asarray(w))
    tw, tstate = torch.tensor(w), talg.init_state(torch.tensor(w))
    for r in range(4):
        x = np.random.default_rng(r).standard_normal((m, d)).astype(np.float32) * 0.2
        key = jax.random.PRNGKey(20 + r)
        jw, jaux, jstate = jalg.apply_round_stateful(key, jw, jnp.asarray(x), jstate)
        k_mech, _ = jalg._split_keys(key)
        noise = RoundNoise()
        if "ldp" in name:
            noise.ldp = torch.tensor(np.asarray(materialize_ldp_noise(k_mech, m, d, kw["sigma"])))
        else:
            noise.central = torch.tensor(np.asarray(jax.random.normal(k_mech, (d,))))
        tw, taux, tstate = talg.apply_round_stateful(None, tw, torch.tensor(x), tstate, noise)
        np.testing.assert_allclose(float(taux.eta_g), float(jaux.eta_g), rtol=1e-7)
        _close_vec(tw.numpy(), jw)


# ---------------------------------------------------------------------------
# noise schedules
# ---------------------------------------------------------------------------

SCHEDULES = [dict(decay=0.9), dict(decay=1.0, boundaries=(3, 7), scales=(0.5, 0.25)),
             dict(decay=0.95, boundaries=(0, 10), scales=(2.0, 0.1))]


@pytest.mark.parametrize("name", ["ldp-fedexp-schedule", "cdp-fedexp-schedule"])
@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
def test_sigma_of_t_and_budget_equal_jax(name, sched):
    kw = _kwargs(name, c=0.3, **SCHEDULES[sched])
    jm, tm = jax_make(name, **kw).mechanism, make_algorithm(name, **kw).mechanism
    assert tm.is_round_indexed and jm.is_round_indexed
    for t in range(25):
        np.testing.assert_allclose(tm.at_round(t).sigma, float(jm.at_round(t).sigma),
                                   rtol=2 ** -21)
        assert tm.sigma_value(t) == jm.sigma_value(t)
        assert type(tm.at_round(t)) is type(tm.inner)
    for rounds in (1, 12, 50):
        for q in (1.0, 0.3):
            got = make_algorithm(name, **kw).budget(1e-5, rounds=rounds, dim=D, sampling_q=q)
            want = jax_make(name, **kw).budget(1e-5, rounds=rounds, dim=D, sampling_q=q)
            assert got.setting == want.setting
            for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
                np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12,
                                           err_msg=f)


@pytest.mark.parametrize("name,inner", [("ldp-fedexp-schedule", "ldp-fedexp-gauss"),
                                        ("cdp-fedexp-schedule", "cdp-fedexp")])
def test_constant_schedule_is_its_inner_name(name, inner, data):
    kw = _kwargs(name)
    alg = make_algorithm(name, **kw)
    assert not alg.needs_round_index
    assert alg.mechanism.at_round(4) is alg.mechanism.inner
    _, ts = _sessions(name, data, **kw)
    _, ti = _sessions(inner, data, **kw)
    a, b = ts.run(3), ti.run(3)
    assert torch.equal(a.final_w, b.final_w) and torch.equal(a.eta_history, b.eta_history)
    got, want = alg.budget(1e-5, rounds=9, dim=D), make_algorithm(inner, **kw).budget(
        1e-5, rounds=9, dim=D)
    assert got == want
    # and the constant schedule against the JAX package's, deterministic at sigma = 0
    js, ts = _sessions(name, data, eta_l=0.3, **_kwargs(name, sigma_scale=0.0))
    jr, tr = js.run(jax.random.PRNGKey(2)), ts.run(2)
    np.testing.assert_allclose(tr.eta_history.numpy(), np.asarray(jr.eta_history), rtol=1e-5)
    _close_vec(tr.last_w.numpy(), jr.last_w)


@pytest.mark.parametrize("name", ["ldp-fedexp-schedule", "cdp-fedexp-schedule"])
def test_decayed_round_matches_jax_at_its_round_index(name):
    m, d, t = 40, 64, 4
    kw = _kwargs(name, c=0.5, decay=0.8, boundaries=(3,), scales=(0.5,))
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    x = np.random.default_rng(0).standard_normal((m, d)).astype(np.float32) * 0.2
    w = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jw, jaux, _ = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x), (), t=t)
    k_mech, extra = jalg._split_keys(key)
    sigma_t = jalg.mechanism.at_round(t).sigma
    noise = RoundNoise()
    if "ldp" in name:
        noise.ldp = torch.tensor(np.asarray(materialize_ldp_noise(k_mech, m, d, sigma_t)))
    else:
        noise.central = torch.tensor(np.asarray(jax.random.normal(k_mech, (d,))))
        noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
    tw, taux = talg.apply_round(None, torch.tensor(w), torch.tensor(x),
                                talg.stage_noise(noise, "cpu", t), t=t)
    np.testing.assert_allclose(float(taux.eta_g), float(jaux.eta_g), rtol=1e-5)
    _close_vec(tw.numpy(), jw)
    with pytest.raises(ValueError, match="pass the round index t"):
        talg.apply_round(None, torch.tensor(w), torch.tensor(x), noise)


def test_decayed_schedule_threads_t_through_the_session(data):
    """sigma(t) falls with t: a session's draws and noise follow the round
    index, and the noisy run agrees with the JAX package's in distribution
    (mean final ||w - w*|| over 8 seeds within 4 standard errors)."""
    kw = _kwargs("ldp-fedexp-schedule", c=0.3, decay=0.7)
    js, ts = _sessions("ldp-fedexp-schedule", data, eta_l=0.3, **kw)
    alg = ts.algorithm
    n0 = alg.draw_noise(round_generator(0, 0), M, D, "cpu", t=0)
    assert n0.seed is not None
    assert alg.mechanism.at_round(5).sigma < alg.mechanism.at_round(0).sigma
    ws = data["w_star"]
    jd = np.array([np.linalg.norm(np.asarray(js.run(jax.random.PRNGKey(s)).final_w) - ws)
                   for s in range(8)])
    td = np.array([np.linalg.norm(ts.run(s).final_w.numpy() - ws) for s in range(8)])
    se = math.sqrt(jd.var(ddof=1) / 8 + td.var(ddof=1) / 8)
    assert np.all(np.isfinite(td)) and abs(jd.mean() - td.mean()) <= 4 * se


def test_schedule_checks_match_jax():
    ldp = GaussianLDP(1.0, 0.7)
    with pytest.raises(ValueError, match="wraps a fixed-sigma Gaussian"):
        NoiseSchedule(inner=PrivUnitLDP(1.0, 2.0, 2.0, 2.0, 32))
    with pytest.raises(ValueError, match="fixed-sigma CentralGaussian"):
        NoiseSchedule(inner=CentralGaussian(z_mult=1.0, num_clients=4))
    with pytest.raises(ValueError, match="decay must be positive"):
        NoiseSchedule(inner=ldp, decay=0.0)
    with pytest.raises(ValueError, match="strictly increasing"):
        NoiseSchedule(inner=ldp, boundaries=(3, 3), scales=(1.0, 1.0))
    with pytest.raises(ValueError, match="one-to-one"):
        NoiseSchedule(inner=ldp, boundaries=(3,), scales=())
    with pytest.raises(ValueError, match="positive"):
        NoiseSchedule(inner=ldp, boundaries=(3,), scales=(-1.0,))
    s = NoiseSchedule(inner=ldp, decay=0.5)
    assert s.clip_norm == 1.0 and not s.needs_xi_key      # forwarded to the inner mechanism
    assert NoiseSchedule(inner=CentralGaussian(clip_norm=1.0, sigma=0.1,
                                               num_clients=4)).needs_xi_key
