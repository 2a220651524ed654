"""The port's adaptive clipping against the JAX package's, on the CPU: the
quantile tracker, CentralGaussian's z_mult mode, AdaptiveClipStep over it and
over PrivUnit, the budget's refusal of a fixed-noise mechanism, and
dp_aggregate taking the clip threshold C as a 0-d tensor.

Rounds read JAX's own draws (its round key split as ``_split_keys`` splits
it) and are held at rtol 1e-5, chained over rounds so that the clip
threshold each side carries is the one it computed.  ``count_below`` counts
``norms <= C``, which can flip between the packages for a norm within an
ulp of C: the data here keep every norm at least 1e-4 C away from the
threshold of each round, and the tests assert that margin.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive_clip as jac  # noqa: E402
from repro.core.algorithm import client_keys  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro_torch.core import adaptive_clip as tac  # noqa: E402
from repro_torch.core.aggregation import fused_clip_aggregate  # noqa: E402
from repro_torch.core.algorithm import RoundNoise, round_generator  # noqa: E402
from repro_torch.core.compose import (  # noqa: E402
    AdaptiveClipStep,
    CentralGaussian,
    GaussianLDP,
    compose_algorithm,
)
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import FederatedSession, TrainSpec  # noqa: E402
from repro_torch.fedsim.local import cohort_updates  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops, ref  # noqa: E402

MARGIN = 1e-4     # least |norm - C| / C of any row in any round here


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


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip,count,m", [(1.0, 13.0, 40.0), (0.3, 0.0, 1000.0),
                                          (2.5, 1000.0, 1000.0), (1e-3, 3.0, 7.0),
                                          (999.0, 1.0, 2.0)])
@pytest.mark.parametrize("sigma_b", [0.0, 10.0])
def test_update_clip_from_stats_matches_jax_with_its_bit_noise(clip, count, m, sigma_b):
    cfg_j = jac.AdaptiveClipConfig(gamma=0.5, lr=0.2, sigma_b=sigma_b)
    cfg_t = tac.AdaptiveClipConfig(gamma=0.5, lr=0.2, sigma_b=sigma_b)
    for s in range(4):
        key = jax.random.PRNGKey(s)
        js, jb = jac.update_clip_from_stats(key, jac.init_state(clip), jnp.float32(count), m,
                                            cfg_j)
        bit = torch.tensor(np.asarray(jax.random.normal(key, ())))
        ts, tb = tac.update_clip_from_stats(bit, tac.init_state(clip), torch.tensor(count), m,
                                            cfg_t)
        np.testing.assert_allclose(float(ts.clip), float(js.clip), rtol=1e-6)
        np.testing.assert_allclose(float(tb), float(jb), rtol=1e-6, atol=1e-7)
        assert ts.clip.dtype == torch.float32 and ts.clip.dim() == 0


def test_update_clip_from_norms_and_rho():
    norms = np.random.default_rng(0).random(50).astype(np.float32) * 2
    key = jax.random.PRNGKey(4)
    cfg = jac.AdaptiveClipConfig()
    js, jb = jac.update_clip(key, jac.init_state(0.77), jnp.asarray(norms), cfg)
    bit = torch.tensor(np.asarray(jax.random.normal(key, ())))
    ts, tb = tac.update_clip(bit, tac.init_state(0.77), torch.tensor(norms),
                             tac.AdaptiveClipConfig())
    np.testing.assert_allclose(float(ts.clip), float(js.clip), rtol=1e-6)
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-6)
    assert tac.adaptive_clip_rho(10.0, 50) == jac.adaptive_clip_rho(10.0, 50) == 0.25


# ---------------------------------------------------------------------------
# dp_aggregate with C as a 0-d tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
@pytest.mark.parametrize("clip", [0.4, 1.0, math.inf])
def test_dp_aggregate_takes_a_tensor_clip_bit_for_bit(mode, clip):
    g = torch.Generator().manual_seed(3)
    u = torch.randn(37, 129, generator=g) * 0.15
    kw = dict(operand=dict(noise=0.5 * torch.randn(37, 129, generator=g)),
              fused=dict(noise_seed=77, noise_sigma=0.3)).get(mode, {})
    want = ops.dp_aggregate_sums(u, clip, **kw)
    got = ops.dp_aggregate_sums(u, torch.tensor(clip), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    noise = kw.get("noise", ref.ldp_noise_ref(37, 129, 77, 0.3) if mode == "fused" else None)
    assert all(torch.equal(a, b) for a, b in
               zip(ref.dp_aggregate_ref(u, noise, torch.tensor(clip)), want))
    for backend in ("torch", "auto"):
        a = fused_clip_aggregate(u, clip, backend=backend, **kw)
        b = fused_clip_aggregate(u, torch.tensor(clip), backend=backend, **kw)
        assert torch.equal(a.cbar, b.cbar) and torch.equal(a.mean_sq, b.mean_sq)


def test_dp_aggregate_refuses_a_tensor_clip_it_cannot_read():
    u = torch.randn(4, 8)
    with pytest.raises(ValueError, match="0-d float32"):
        ops.dp_aggregate_sums(u, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="0-d float32"):
        ops.dp_aggregate_sums(u, torch.tensor(1.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="lies on meta"):
        ops.dp_aggregate_sums(u, torch.empty((), device="meta"))


# ---------------------------------------------------------------------------
# the composition
# ---------------------------------------------------------------------------

def test_central_gaussian_checks_match_jax():
    with pytest.raises(ValueError, match="exactly one of sigma"):
        CentralGaussian(num_clients=5)
    with pytest.raises(ValueError, match="exactly one of sigma"):
        CentralGaussian(clip_norm=1.0, sigma=0.1, z_mult=1.0, num_clients=5)
    with pytest.raises(ValueError, match="requires clip_norm"):
        CentralGaussian(sigma=0.1, num_clients=5)
    with pytest.raises(ValueError, match="num_clients >= 1"):
        CentralGaussian(z_mult=1.0)
    assert CentralGaussian(z_mult=1.0, num_clients=3).clip_independent_budget
    assert not CentralGaussian(clip_norm=1.0, sigma=0.1, num_clients=3).clip_independent_budget


def _deltas(m, d, seed):
    x = np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)
    return x * (1.6 * np.random.default_rng(seed + 1).random((m, 1))
                / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _margin(x, clip) -> float:
    n = np.linalg.norm(x.astype(np.float64), axis=1)
    return float(np.min(np.abs(n - clip)) / clip)


CASES = {
    "cdp-fedexp-adaptive-clip": dict(z_mult=1.2, num_clients=40, c0=0.6, sigma_b=4.0),
    "privunit-fedexp-adaptive-clip": dict(clip_norm=1.0, c0=0.6, eps0=2.0, eps1=2.0, eps2=2.0,
                                          dim=100, sigma_b=4.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_chained_rounds_match_jax_on_its_draws(name):
    m, d = 40, 100
    kw = CASES[name]
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    w = np.zeros(d, np.float32)
    jw, jstate = jnp.asarray(w), jalg.init_state(jnp.asarray(w))
    tw, tstate = torch.tensor(w), talg.init_state(torch.tensor(w))
    assert float(tstate.clip) == np.float32(0.6) and tstate.clip.dtype == torch.float32
    for r in range(3):
        x = _deltas(m, d, 10 * r)
        assert _margin(x, float(jstate.clip)) > MARGIN
        key = jax.random.PRNGKey(50 + r)
        jw, jaux, jstate = jalg.apply_round_stateful(key, jw, jnp.asarray(x), jstate)
        k_mech, extra = jalg._split_keys(key)
        noise = RoundNoise(bit=torch.tensor(np.asarray(jax.random.normal(extra[-1], ()))))
        if name.startswith("cdp"):
            noise.central = torch.tensor(np.asarray(jax.random.normal(k_mech, (d,))))
            noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
        else:
            for f, v in jax_draws(client_keys(k_mech, m, 0), d, jalg.mechanism.sc.k).items():
                setattr(noise, f, torch.tensor(v))
        tw, taux, tstate = talg.apply_round_stateful(None, tw, torch.tensor(x), tstate, noise)
        np.testing.assert_allclose(float(taux.eta_g), float(jaux.eta_g), rtol=1e-5)
        np.testing.assert_allclose(float(taux.update_norm), float(jaux.update_norm), rtol=1e-6)
        np.testing.assert_allclose(float(tstate.clip), float(jstate.clip), rtol=1e-5)
        _close_vec(tw.numpy(), jw)


class NoHostRead(torch.Tensor):
    """A tensor whose value the host must not read (no item(), float(), bool())."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.__float__, torch.Tensor.__bool__,
                    torch.Tensor.__int__, torch.Tensor.tolist, torch.Tensor.numpy):
            raise AssertionError(f"the round read C on the host through {func.__name__}")
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("name", list(CASES))
def test_the_round_never_reads_the_clip_on_the_host(name):
    m, d = 40, 100
    alg = make_algorithm(name, **CASES[name])
    w = torch.zeros(d)
    state = alg.init_state(w)
    state.clip = state.clip.as_subclass(NoHostRead)
    x = torch.tensor(_deltas(m, d, 3))
    for t in range(2):
        w, aux, state = alg.apply_round_stateful(round_generator(0, t), w, x, state, t=t)
        assert isinstance(state.clip, NoHostRead)
    assert torch.isfinite(w.as_subclass(torch.Tensor)).all()


M, D, TAU, ROUNDS = 40, 32, 5, 6


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def test_deterministic_session_matches_jax(data):
    """z_mult = 0 and sigma_b = 0: no noise anywhere, so the run is a
    function of the data; held at rtol 1e-5, with every round's norms at
    least MARGIN away from that round's C (replayed on the port's side)."""
    kw = dict(z_mult=0.0, num_clients=M, c0=0.05, sigma_b=0.0)
    eta_l = 0.1
    js = JaxSession(jax_make("cdp-fedexp-adaptive-clip", **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=eta_l))
    alg = make_algorithm("cdp-fedexp-adaptive-clip", **kw)
    ts = FederatedSession(alg, linreg_loss, np.zeros(D, np.float32),
                          {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=eta_l), device="cpu")
    jr, tr = js.run(jax.random.PRNGKey(1)), ts.run(1)
    np.testing.assert_allclose(tr.eta_history.numpy(), np.asarray(jr.eta_history), rtol=1e-5)
    _close_vec(tr.final_w.numpy(), jr.final_w)
    _close_vec(tr.last_w.numpy(), jr.last_w)
    # replay: the clip moves every round and the norms stay clear of it
    w, state, clips = ts._w0, alg.init_state(ts._w0), []
    for t in range(ROUNDS):
        deltas = cohort_updates(linreg_loss, w, ts.client_batches, TAU, eta_l)
        assert _margin(deltas.numpy(), float(state.clip)) > MARGIN
        clips.append(float(state.clip))
        w, _, state = alg.apply_round_stateful(round_generator(1, t), w, deltas, state, t=t)
    assert torch.equal(w, tr.last_w)
    assert len(set(clips)) == ROUNDS


def test_noisy_session_agrees_with_jax_in_distribution(data):
    kw = dict(z_mult=1.0, num_clients=M, c0=0.3)
    js = JaxSession(jax_make("cdp-fedexp-adaptive-clip", **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=0.1))
    ts = FederatedSession(make_algorithm("cdp-fedexp-adaptive-clip", **kw), linreg_loss,
                          np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                          train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=0.1), device="cpu")
    ws = data["w_star"]
    jd = np.array([np.linalg.norm(np.asarray(js.run(jax.random.PRNGKey(s)).final_w) - ws)
                   for s in range(8)])
    td = np.array([np.linalg.norm(ts.run(s).final_w.numpy() - ws) for s in range(8)])
    se = math.sqrt(jd.var(ddof=1) / 8 + td.var(ddof=1) / 8)
    assert np.all(np.isfinite(td)) and abs(jd.mean() - td.mean()) <= 4 * se


@pytest.mark.parametrize("name", list(CASES))
def test_budget_equals_jax(name):
    kw = CASES[name]
    got = make_algorithm(name, **kw).budget(1e-5, rounds=20, dim=100)
    want = jax_make(name, **kw).budget(1e-5, rounds=20, dim=100)
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)


@pytest.mark.parametrize("mechanism", [GaussianLDP(1.0, 0.7),
                                       CentralGaussian(clip_norm=1.0, sigma=0.5,
                                                       num_clients=10)])
def test_budget_refuses_fixed_noise_under_adaptive_clipping(mechanism):
    alg = compose_algorithm(mechanism, AdaptiveClipStep())
    with pytest.raises(ValueError, match="fixed-noise mechanism with adaptive clipping"):
        alg.budget(1e-5, rounds=10, dim=8)
    # it still runs: the refusal is the accounting's, not the release's
    w, _, state = alg.apply_round_stateful(round_generator(0, 0), torch.zeros(8),
                                           torch.randn(10, 8), alg.init_state(torch.zeros(8)))
    assert torch.isfinite(w).all() and state.clip.dim() == 0
