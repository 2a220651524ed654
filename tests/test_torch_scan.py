"""The port's scan engine (``EngineSpec("scan")``, ``fedsim/scan.py``) on the CPU.

On the CPU the engine runs its stage, body and commit uncaptured (the card
replays the same body from CUDA graphs: ``tests/test_torch_cuda.py`` and
chip_smoke phase 4b).  ``EngineSpec`` refuses what the JAX package's
refuses, case for case; a scan run equals the eager run in bits for every
registry name in dense, gathered and faulted rounds, for every
``chunk_rounds`` and ``scan_unroll``; a tripped watchdog stops both engines
at the same round with the same histories; a scan checkpoint resumes under
eager in bits; and one staged round (``round_stage``'s form of the round's
noise through ``round_body``) equals JAX's ``_round_step`` at rtol 1e-5 on
JAX's own noise (``round_noise_of``).  Sizes: M = 40, d = 16 or 24, at most
6 rounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.server import _round_step  # noqa: E402
from repro.fedsim.specs import EngineSpec as JaxEngine  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    EngineSpec,
    FaultSpec,
    FederatedSession,
    LocalSpec,
    TrainSpec,
    cohort_updates,
)
from repro_torch.fedsim.server import RoundInputs, round_body  # noqa: E402
from test_torch_moments import COMPOSED, algo_kwargs, close, close_vec, round_noise_of  # noqa: E402

M, D, TAU, ETA_L, ROUNDS = 40, 16, 3, 0.1, 6
FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: torch.tensor(np.array(getattr(d, k))) for k in ("x", "y", "w_star")}


def kwargs_of(name):
    """make_algorithm kwargs at the test size (dp-scaffold in LDP mode)."""
    if name == "dp-scaffold":
        return dict(clip_norm=1.0, sigma=0.7, central=False, num_clients=M, tau=TAU,
                    eta_l=ETA_L)
    return algo_kwargs(name, M, D)


def session(name, data, engine, rounds=ROUNDS, **specs):
    local = LocalSpec(control_variates=True) if name == "dp-scaffold" else specs.pop("local",
                                                                                     None)
    return FederatedSession(make_algorithm(name, **kwargs_of(name)), linreg_loss, torch.zeros(D),
                            {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L, eval_every=2),
                            engine=engine, local=local, eval_fn=distance_to_opt(data["w_star"]),
                            device="cpu", **specs)


def same_bits(a, b):
    """Two RunResults equal in bits (NaN where both are NaN), fault round too."""
    assert a.fault_round == b.fault_round
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), f


SCAN = EngineSpec("scan", chunk_rounds=4, scan_unroll=2)

# ---------------------------------------------------------------------------
# EngineSpec
# ---------------------------------------------------------------------------

ENGINE_CASES = [dict(), dict(engine="scan"), dict(engine="eager"), dict(engine="stream"),
                dict(engine="jit"), dict(chunk_rounds=0), dict(chunk_rounds=-2),
                dict(chunk_rounds=5), dict(scan_unroll=0), dict(scan_unroll=3),
                dict(donate=True), dict(engine="scan", chunk_rounds=1, scan_unroll=1,
                                        donate=False)]


@pytest.mark.parametrize("kw", ENGINE_CASES, ids=str)
def test_engine_spec_accepts_and_refuses_what_jax_does(kw):
    try:
        want = JaxEngine(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            EngineSpec(**kw)
        assert str(err.value) == str(e)
        return
    got = EngineSpec(**kw)
    # the port's default engine stays "eager"; named, the specs print alike
    if "engine" in kw:
        assert repr(got) == repr(want)
    else:
        assert got.engine == "eager" and want.engine == "scan"
        assert (got.chunk_rounds, got.scan_unroll, got.donate) == (
            want.chunk_rounds, want.scan_unroll, want.donate)


# ---------------------------------------------------------------------------
# scan = eager in bits
# ---------------------------------------------------------------------------

KINDS = {"dense": {}, "gathered": dict(cohort=CohortSpec(q=0.3, gather=True)),
         "faulted": dict(fault=FaultSpec(dropout=0.2, straggler=0.2, straggler_steps=1,
                                         corrupt=0.1))}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list_algorithms())
def test_scan_equals_eager_in_bits(name, kind, data):
    want = session(name, data, EngineSpec("eager"), **KINDS[kind]).run(3)
    got = session(name, data, SCAN, **KINDS[kind]).run(3)
    same_bits(got, want)


@pytest.mark.parametrize("chunk", [1, 3, None])
@pytest.mark.parametrize("unroll", [1, 2])
def test_chunks_and_unroll_give_the_same_bits(chunk, unroll, data):
    """cdp-fedexp-adaptive-clip (a carried clip) at eval_every = 2 (two round
    kinds), under Bernoulli sampling with replacement of dp-scaffold's kind
    covered above: every chunk grid and graph size gives the eager bits."""
    name = "cdp-fedexp-adaptive-clip"
    want = session(name, data, EngineSpec("eager")).run(5)
    got = session(name, data, EngineSpec("scan", chunk_rounds=chunk, scan_unroll=unroll)).run(5)
    same_bits(got, want)


def test_minibatch_and_replacement_cohorts_replay(data):
    """A minibatch trainer (its shuffle key staged) and dp-scaffold under a
    fixed cohort drawn with replacement (its expanded rows staged)."""
    batches = {"x": data["x"][:, None, :].expand(M, 4, D).contiguous(),
               "y": data["y"][:, None].expand(M, 4).contiguous()}

    def loss(w, b):
        return torch.mean((b["x"] @ w - b["y"]) ** 2)

    def run(engine):
        s = FederatedSession(make_algorithm("cdp-fedexp", **kwargs_of("cdp-fedexp")), loss,
                             torch.zeros(D), batches,
                             train=TrainSpec(rounds=4, tau=TAU, eta_l=ETA_L), engine=engine,
                             local=LocalSpec(batch_size=2, epochs=2, momentum=0.5),
                             cohort=CohortSpec(q=0.4, gather=True), device="cpu")
        return s.run(5)
    same_bits(run(SCAN), run(EngineSpec("eager")))
    rep = dict(cohort=CohortSpec(size=12, replace=True),
               fault=FaultSpec(dropout=0.2, corrupt=0.1))
    same_bits(session("dp-scaffold", data, SCAN, **rep).run(2),
              session("dp-scaffold", data, EngineSpec("eager"), **rep).run(2))


@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss"])
def test_a_tripped_watchdog_stops_both_engines_alike(name, data):
    fault = FaultSpec(dropout=0.1, watchdog=True, eta_max=1.05)
    want = session(name, data, EngineSpec("eager"), fault=fault).run(0)
    got = session(name, data, SCAN, fault=fault).run(0)
    assert want.fault_round is not None
    same_bits(got, want)
    assert torch.isnan(got.eta_history[want.fault_round + 1:]).all()


def test_a_scan_checkpoint_resumes_under_eager_in_bits(data, tmp_path):
    name = "ldp-gauss-fedadam"   # a server optimizer's moments and step count in the carry
    session(name, data, SCAN, rounds=3).run(4, checkpoint_dir=str(tmp_path))
    got = session(name, data, EngineSpec("eager")).resume(str(tmp_path))
    same_bits(got, session(name, data, EngineSpec("eager")).run(4))
    # and the other way round, with the watchdog armed on both
    fault = FaultSpec(watchdog=True)
    session(name, data, EngineSpec("eager"), rounds=3, fault=fault).run(
        4, checkpoint_dir=str(tmp_path / "b"))
    same_bits(session(name, data, SCAN, fault=fault).resume(str(tmp_path / "b")),
              session(name, data, SCAN, fault=fault).run(4))


def test_run_batched_reuses_the_graphs_and_equals_run(data):
    s = session("ldp-fedexp-gauss", data, SCAN)
    sweep = s.run_batched([0, 1])
    for i, seed in enumerate((0, 1)):
        one = s.run(seed)
        for f in FIELDS:
            assert torch.equal(getattr(sweep, f)[i].nan_to_num(7.0),
                               getattr(one, f).nan_to_num(7.0)), f


def test_compression_under_scan_is_refused(data):
    from repro_torch.core.compose import RandKAggregation, with_compression
    alg = with_compression(make_algorithm("cdp-fedexp", **kwargs_of("cdp-fedexp")),
                           RandKAggregation(k=8))
    with pytest.raises(ValueError, match="compressed aggregation"):
        FederatedSession(alg, linreg_loss, torch.zeros(D), {"x": data["x"], "y": data["y"]},
                         train=TrainSpec(rounds=2, tau=TAU, eta_l=ETA_L), engine=SCAN,
                         device="cpu")


# ---------------------------------------------------------------------------
# one staged round against JAX's _round_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", COMPOSED)
def test_a_staged_round_matches_jax_round_step(name, data):
    d = 24
    jd = jax_data(jax.random.PRNGKey(1), M, d)
    batches = {"x": np.array(jd.x), "y": np.array(jd.y)}
    kw = algo_kwargs(name, M, d)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    w = (0.3 * np.random.default_rng(31).standard_normal(d)).astype(np.float32)
    t, key = 2, jax.random.PRNGKey(60)
    step = _round_step(jalg, jlocal.build_cohort_local_fn(jax_loss, None, TAU), None, 1,
                       tau=TAU)
    jw, jstate, jouts = step(jnp.asarray(w), jalg.init_state(jnp.asarray(w)), key, t,
                             {k: jnp.asarray(v) for k, v in batches.items()}, ETA_L)

    def local_fn(w_, b, eta):
        return cohort_updates(linreg_loss, w_, b, TAU, eta)

    tw0 = torch.tensor(w)
    inp = RoundInputs(noise=talg.stage_noise(round_noise_of(jalg, key, M, d, t, raw=True), "cpu",
                                             t))
    body = round_body(talg, local_fn, None)
    tw, tstate, outs = body(tw0, talg.init_state(tw0), inp, t,
                            {k: torch.tensor(v) for k, v in batches.items()}, ETA_L)
    close(outs[0], jouts[0], what="eta_g")
    for g, j, f in zip(outs[2:], jouts[2:], ("eta_naive", "eta_target")):
        assert np.isnan(float(g)) == np.isnan(float(j)), f
        if not np.isnan(float(g)):
            close(g, j, what=f)
    close_vec(tw.numpy(), jw)
    if "adaptive-clip" in name:
        close(tstate.clip, jstate.clip, what="clip")
