"""The port's pre-session API on the CPU: the deprecated ``run_federated`` /
``run_federated_batched`` shims against the session in bits, the Gaussian
mechanisms' configs against the JAX package's, the two Gaussian randomizers
against their closed form, ``materialize_ldp_noise`` against the plain noise
version's rows, ``client_keys``, and the two examples at a tiny size.
"""
import dataclasses
import importlib.util
import math
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import mechanisms as jmech  # noqa: E402
from repro_torch.core import mechanisms as tmech  # noqa: E402
from repro_torch.core.aggregation import (  # noqa: E402
    global_client_indices,
    materialize_ldp_noise,
    partial_clip_moments,
)
from repro_torch.core.algorithm import client_keys  # noqa: E402
from repro_torch.core.fedexp import CDPFedEXP, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)
from repro_torch.fedsim import (  # noqa: E402
    EngineSpec,
    FederatedSession,
    TrainSpec,
    run_federated,
    run_federated_batched,
)
from repro_torch.fedsim import server  # noqa: E402
from repro_torch.kernels.dp_aggregate import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M, D, TAU, ETA_L, ROUNDS = 16, 10, 2, 0.1, 4
FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread (a pool of them only contends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_linreg(torch.Generator().manual_seed(5), M, D)


def bits_equal(a, b):
    """Equal in bits, NaN included."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)))


def same_result(a, b):
    return all(bits_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def algorithms():
    return {"cdp-fedexp": CDPFedEXP(clip_norm=0.5, sigma=0.3, num_clients=M),
            "ldp-fedexp-gauss": make_algorithm("ldp-fedexp-gauss", clip_norm=0.5, sigma=0.2)}


def session_of(alg, problem, engine=EngineSpec(), **kw):
    return FederatedSession(alg, linreg_loss, torch.zeros(D), problem.client_batches(),
                            train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L, **kw),
                            engine=engine, eval_fn=distance_to_opt(problem.w_star), device="cpu")


# ---------------------------------------------------------------------------
# the deprecated shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", [dict(), dict(engine="eager"),
                                    dict(engine="scan", chunk_rounds=3, scan_unroll=1)],
                         ids=["scan", "eager", "scan-chunked"])
@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss"])
def test_run_federated_is_the_session_in_bits(problem, name, engine):
    alg = algorithms()[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = run_federated(alg, linreg_loss, torch.zeros(D), problem.client_batches(),
                            rounds=ROUNDS, tau=TAU, eta_l=ETA_L, seed=3, avg_last=3,
                            eval_fn=distance_to_opt(problem.w_star), device="cpu", **engine)
    want = session_of(alg, problem, EngineSpec(**engine), avg_last=3).run(3)
    assert same_result(got, want)


def test_run_federated_batched_is_the_session_sweep_in_bits(problem):
    alg = algorithms()["cdp-fedexp"]
    seeds = [0, 4, 9]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        kw = dict(rounds=ROUNDS, tau=TAU, eta_l=ETA_L,
                  eval_fn=distance_to_opt(problem.w_star), device="cpu")
        got = run_federated_batched(alg, linreg_loss, torch.zeros(D), problem.client_batches(),
                                    seeds=seeds, **kw)
        each = [run_federated(alg, linreg_loss, torch.zeros(D), problem.client_batches(),
                              seed=s, **kw) for s in seeds]
    want = session_of(alg, problem).run_batched(seeds)
    assert same_result(got, want)
    for f in FIELDS:
        assert bits_equal(getattr(got, f), torch.stack([getattr(r, f) for r in each])), f


def test_run_federated_batched_takes_seed_axes(problem):
    alg = algorithms()["ldp-fedexp-gauss"]
    w0 = torch.stack([torch.zeros(D), 0.1 * torch.ones(D)])
    data = {k: torch.stack([v, 2.0 * v]) for k, v in problem.client_batches().items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = run_federated_batched(alg, linreg_loss, w0, data, rounds=ROUNDS, tau=TAU,
                                    eta_l=ETA_L, seeds=[1, 2], batched_w0=True,
                                    batched_data=True, device="cpu")
    for i, seed in enumerate((1, 2)):
        one = FederatedSession(alg, linreg_loss, w0[i], {k: v[i] for k, v in data.items()},
                               train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                               device="cpu").run(seed)
        for f in FIELDS:
            assert bits_equal(getattr(got, f)[i], getattr(one, f)), f


def test_the_shims_warn_once_per_process(problem, monkeypatch):
    monkeypatch.setattr(server, "_deprecation_warned", False)
    alg = algorithms()["cdp-fedexp"]
    args = (alg, linreg_loss, torch.zeros(D), problem.client_batches())
    kw = dict(rounds=1, tau=1, eta_l=ETA_L, device="cpu")
    with pytest.warns(DeprecationWarning, match="FederatedSession"):
        run_federated(*args, seed=0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run_federated(*args, seed=1, **kw)
        run_federated_batched(*args, seeds=[0], **kw)
    monkeypatch.setattr(server, "_deprecation_warned", False)
    with pytest.warns(DeprecationWarning, match="run_federated_batched is deprecated"):
        run_federated_batched(*args, seeds=[0], **kw)


# ---------------------------------------------------------------------------
# the Gaussian mechanisms
# ---------------------------------------------------------------------------

def test_gaussian_configs_match_jax():
    for t, j in ((tmech.GaussianLDPConfig(0.7, 1.0), jmech.GaussianLDPConfig(0.7, 1.0)),
                 (tmech.GaussianCDPConfig(0.3, 1.0, 1000),
                  jmech.GaussianCDPConfig(0.3, 1.0, 1000))):
        assert t.__dict__ == j.__dict__
    t, j = tmech.GaussianCDPConfig(0.3, 1.0, 1000), jmech.GaussianCDPConfig(0.3, 1.0, 1000)
    assert t.mean_noise_std == j.mean_noise_std == 0.3 / math.sqrt(1000)
    assert t.sigma_xi(131072) == j.sigma_xi(131072)
    eps = (0.5, 1.0, 1.0, 4.0, 8.0)
    t = tmech.PerClientGaussianConfig(1.0, eps, 1e-5)
    j = jmech.PerClientGaussianConfig(1.0, eps, 1e-5)
    assert t.epsilons == j.epsilons
    np.testing.assert_allclose(t.sigmas, j.sigmas, rtol=1e-12, atol=0)
    assert t.sigmas == tmech.per_client_sigmas(eps, 1e-5, 1.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.clip_norm = 2.0


def test_gaussian_randomizers_are_their_closed_form():
    delta = torch.linspace(-1.0, 1.0, 37)
    gen = torch.Generator().manual_seed(8)
    want = delta + 0.7 * torch.randn(37, generator=torch.Generator().manual_seed(8))
    assert torch.equal(tmech.gaussian_ldp_randomize(gen, delta, 0.7), want)
    gen = torch.Generator().manual_seed(9)
    got = tmech.gaussian_cdp_noise(gen, (4, 5), 0.25)
    want = 0.25 * torch.randn((4, 5), generator=torch.Generator().manual_seed(9))
    assert got.dtype == torch.float32 and got.device.type == "cpu" and torch.equal(got, want)
    got = tmech.gaussian_cdp_noise(torch.Generator().manual_seed(9), [6], 2.0, torch.float64,
                                   "cpu")
    want = 2.0 * torch.randn(6, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    assert got.dtype == torch.float64 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# materialize_ldp_noise and client_keys
# ---------------------------------------------------------------------------

def test_materialize_ldp_noise_is_the_noise_rows():
    m, d, seed, sigma = 40, 33, 0xC0FFEE, 0.6
    dense = ref.ldp_noise_ref(m, d, seed, sigma)
    assert torch.equal(materialize_ldp_noise(seed, m, d, sigma, device="cpu"), dense)
    assert torch.equal(materialize_ldp_noise(seed, 9, d, sigma, start=17, device="cpu"),
                       dense[17:26])
    ids = torch.tensor([3, 39, 0, 12, 12, 5])
    got = materialize_ldp_noise(seed, 6, d, sigma, start=ids, device="cpu")
    assert torch.equal(got, dense[ids])
    half = materialize_ldp_noise(seed, 6, d, sigma, torch.float16, start=ids, device="cpu")
    assert half.dtype == torch.float16 and torch.equal(half, dense[ids].half())
    # the rows are what the fused (seeded) release adds: a zero update releases its noise
    one = partial_clip_moments(torch.zeros(1, d), 1.0, noise_seed=seed, noise_sigma=sigma,
                               start=torch.tensor([39]))
    assert torch.equal(one.sum_c, dense[39])


def test_client_keys_are_the_seed_beside_the_global_indices():
    seed = 2**32 + 77          # the round's seed is 32 bits
    keys = client_keys(seed, 5, 11)
    assert keys.shape == (5, 2) and keys.dtype == torch.int64
    assert torch.equal(keys[:, 0], torch.full((5,), 77))
    assert torch.equal(keys[:, 1], global_client_indices(11, 5, "cpu"))
    ids = torch.tensor([4, 0, 9])
    assert torch.equal(client_keys(5, 3, ids)[:, 1], ids)
    assert torch.equal(client_keys(5, 3)[:, 1], torch.arange(3))


# ---------------------------------------------------------------------------
# the examples, at a tiny size on the CPU
# ---------------------------------------------------------------------------

def load_example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["hyperfree_adaptivity_torch", "serve_batched_torch"])
def test_the_examples_stand_alone(name):
    """The examples import neither jax nor the JAX package."""
    from test_torch_imports import BANNED, _imported_roots
    assert not set(_imported_roots(ROOT / "examples" / f"{name}.py")) & (BANNED | {"."})


def test_hyperfree_adaptivity_example_on_the_cpu(monkeypatch, capsys):
    ex = load_example("hyperfree_adaptivity_torch")
    assert (ex.D, ex.TAU, ex.ROUNDS, ex.CLIP, ex.ETA_L) == (200, 20, 30, 0.3, 0.1)
    assert ex.COHORTS == (200, 1000) and ex.NOISE_MULTS == (1.0, 3.0, 10.0)
    for k, v in dict(D=8, TAU=2, ROUNDS=3, COHORTS=(12, 24)).items():
        monkeypatch.setattr(ex, k, v)
    rows = ex.main(device="cpu")
    assert [(m, s) for m, s, _, _ in rows] == [(m, s) for m in (12, 24) for s in ex.NOISE_MULTS]
    assert all(math.isfinite(eta) and eta >= 1.0 and math.isfinite(dist)
               for _, _, eta, dist in rows)
    assert "Remark 3.1" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "gemma-2b"])
def test_serve_batched_example_on_the_cpu(arch, capsys):
    ex = load_example("serve_batched_torch")
    out = ex.main(["--arch", arch, "--cpu", "--batch", "2", "--prompt-len", "6", "--new", "3"])
    assert out.shape == (2, 3) and out.dtype == torch.int64
    assert f"arch={arch}" in capsys.readouterr().out


def test_serve_batched_example_refuses_an_audio_arch():
    ex = load_example("serve_batched_torch")
    with pytest.raises(SystemExit, match="decoder arch"):
        ex.main(["--arch", "whisper-large-v3", "--cpu"])
