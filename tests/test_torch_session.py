"""The port's FederatedSession against the JAX package's, on the CPU.

Both packages get the same client data (made by the JAX package's generator)
and the same hyperparameters (benchmarks/e1_synthetic.py; the noiseless names
at eta_l 0.3).  With sigma = 0 the runs are deterministic functions of the
data and are held at rtol 1e-5: the eta history per round, and the final
iterate with an atol of 1e-5 times its largest entry.  With noise the two
packages draw different numbers, so runs are held statistically.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import EngineSpec, FederatedSession, TrainSpec  # noqa: E402

M, D, TAU, ROUNDS = 40, 32, 5, 5
HP = {"fedavg": (0.3, None), "fedexp": (0.3, None),
      "dp-fedavg-ldp-gauss": (0.3, 1.0), "ldp-fedexp-gauss": (0.3, 0.3),
      "dp-fedavg-cdp": (0.3, 3.0), "cdp-fedexp": (0.1, 0.3)}
NOISY = [n for n, (_, c) in HP.items() if c is not None]


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def _kwargs(name, sigma_scale=1.0):
    c = HP[name][1]
    if c is None:
        return {}
    if "cdp" in name:
        return dict(clip_norm=c, sigma=sigma_scale * 5 * c / math.sqrt(M), num_clients=M)
    return dict(clip_norm=c, sigma=sigma_scale * 0.7 * c)


def _sessions(name, data, sigma_scale=1.0, eta_l=None):
    eta_l = HP[name][0] if eta_l is None else eta_l
    kw = _kwargs(name, sigma_scale)
    js = JaxSession(jax_make(name, **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=eta_l))
    ts = FederatedSession(make_algorithm(name, **kw), linreg_loss, np.zeros(D, np.float32),
                          {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=eta_l),
                          eval_fn=distance_to_opt(torch.tensor(data["w_star"])), device="cpu")
    return js, ts


def _close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", list(HP))
def test_noiseless_runs_match_jax(name, data):
    """fedavg, fedexp, and every noisy name at sigma = 0."""
    js, ts = _sessions(name, data, sigma_scale=0.0)
    jr, tr = js.run(jax.random.PRNGKey(1)), ts.run(1)
    np.testing.assert_allclose(tr.eta_history.numpy(), np.asarray(jr.eta_history), rtol=1e-5)
    _close_vec(tr.final_w.numpy(), jr.final_w)
    _close_vec(tr.last_w.numpy(), jr.last_w)


def test_fedexp_where_float32_is_ill_conditioned_stays_on_the_float64_path(data):
    """At eta_l = 0.1 FedEXP extrapolates by up to 49x, and float32 rounding
    alone moves eta by ~1e-5 (the JAX package is 1.2e-5 from float64 there):
    the port is held to a float64 run of the same algorithm instead."""
    x, y = data["x"].astype(np.float64), data["y"].astype(np.float64)
    w, etas = np.zeros(D), []
    for _ in range(ROUNDS):
        wc = np.tile(w, (M, 1))
        for _ in range(TAU):
            wc = wc - 0.1 * 2 * (np.sum(x * wc, 1) - y)[:, None] * x
        deltas = wc - w
        cbar = deltas.mean(0)
        etas.append(max(1.0, np.mean(np.sum(deltas**2, 1)) / np.sum(cbar**2)))
        w = w + etas[-1] * cbar
    _, ts = _sessions("fedexp", data, eta_l=0.1)
    tr = ts.run(0)
    assert max(etas) > 40
    np.testing.assert_allclose(tr.eta_history.numpy(), etas, rtol=1e-5)
    _close_vec(tr.last_w.numpy(), w)


@pytest.mark.parametrize("name", NOISY)
def test_noisy_runs_are_deterministic_per_seed(name, data):
    _, ts = _sessions(name, data)
    a, b, c = ts.run(3), ts.run(3), ts.run(4)
    assert torch.equal(a.final_w, b.final_w) and torch.equal(a.eta_history, b.eta_history)
    assert not torch.equal(a.final_w, c.final_w)


@pytest.mark.parametrize("name", NOISY)
def test_noisy_final_distance_agrees_with_jax_in_distribution(name, data):
    """The packages draw different noise; over 8 seeds each, the mean final
    ||w - w*|| must agree within 4 standard errors of the difference."""
    js, ts = _sessions(name, data)
    ws = data["w_star"]
    seeds = range(8)
    jd = np.array([np.linalg.norm(np.asarray(js.run(jax.random.PRNGKey(s)).final_w) - ws)
                   for s in seeds])
    td = np.array([np.linalg.norm(ts.run(s).final_w.numpy() - ws) for s in seeds])
    se = math.sqrt(jd.var(ddof=1) / len(jd) + td.var(ddof=1) / len(td))
    assert np.all(np.isfinite(td))
    assert abs(jd.mean() - td.mean()) <= 4 * se, (jd.mean(), td.mean(), se)


@pytest.mark.parametrize("name", NOISY)
def test_privacy_report_equals_jax(name, data):
    js, ts = _sessions(name, data)
    got, want = ts.privacy_report(1e-5), js.privacy_report(1e-5)
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)


def test_privacy_report_raises_for_non_private(data):
    _, ts = _sessions("fedexp", data)
    with pytest.raises(ValueError, match="not a private algorithm"):
        ts.privacy_report(1e-5)


def test_tree_params_match_flat_params(data):
    """A {"W", "b"} model flattens in ravel_pytree's order and trains like the flat one."""
    def tree_loss(p, batch):
        return linreg_loss(torch.cat([p["W"].reshape(-1), p["b"]]), batch)

    alg = make_algorithm("fedexp")
    batches = {"x": data["x"], "y": data["y"]}
    train = TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=0.3)
    flat = FederatedSession(alg, linreg_loss, np.zeros(D, np.float32), batches,
                            train=train, device="cpu").run(0)
    tree = FederatedSession(alg, tree_loss, {"b": np.zeros(2, np.float32),
                                             "W": np.zeros((3, 10), np.float32)},
                            batches, train=train, device="cpu").run(0)
    assert set(tree.final_w) == {"W", "b"} and tree.final_w["W"].shape == (3, 10)
    got = torch.cat([tree.final_w["W"].reshape(-1), tree.final_w["b"]])
    assert torch.equal(got, flat.final_w)


def test_eval_cadence_and_history_shapes(data):
    ts = FederatedSession(make_algorithm("fedavg"), linreg_loss, np.zeros(D, np.float32),
                          {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=5, tau=2, eta_l=0.3, eval_every=2),
                          eval_fn=distance_to_opt(torch.tensor(data["w_star"])),
                          device="cpu")
    r = ts.run(0)
    assert r.eta_history.shape == r.metric_history.shape == (5,)
    assert [t for t, _ in r.eval_rounds()] == [1, 3]
    assert math.isnan(float(r.metric_history[0]))


def test_device_and_engine_guards(data):
    if torch.cuda.is_available():
        pytest.skip("the missing-card error needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedSession(make_algorithm("fedavg"), linreg_loss, np.zeros(D, np.float32),
                         {"x": data["x"], "y": data["y"]},
                         train=TrainSpec(rounds=1, tau=1, eta_l=0.1))
    assert EngineSpec(engine="scan").engine == "scan"
    with pytest.raises(ValueError, match="unknown engine"):
        EngineSpec(engine="jit")
