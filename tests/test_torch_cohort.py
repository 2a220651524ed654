"""The port's sampled cohorts against the JAX package's, on the CPU.

``CohortSpec`` (validation, the gather cap, the sampling rate), the gather
helpers, one sampled round of every name against JAX's ``_round_step`` fed
the same participation mask and the JAX round's own randomness (dense,
gathered, fixed-size and with replacement), gathered sessions against dense
ones in the port, full participation bit for bit through ``CohortSpec()``,
the samplers' statistics, and the privacy report under sampling.  Float32 at
rtol 1e-5; the float64 accounting at rtol 1e-12.
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
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.server import _round_step  # noqa: E402
from repro.fedsim.specs import CohortSpec as JaxCohort  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    FederatedSession,
    TrainSpec,
    cohort_updates,
    gather_rows,
    gather_slots,
    mask_rows,
)
from repro_torch.fedsim.server import masked_round, stage_inputs  # noqa: E402
from test_torch_moments import (  # noqa: E402
    COMPOSED,
    algo_kwargs,
    close,
    close_vec,
    round_noise_of,
)

M, D, TAU, ETA_L, ROUNDS = 40, 24, 3, 0.1, 5


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


# ---------------------------------------------------------------------------
# CohortSpec
# ---------------------------------------------------------------------------

BAD = [dict(q=0.0), dict(q=1.5), dict(size=0), dict(q=0.5, size=3), dict(replace=True),
       dict(gather=True), dict(size=4, replace=True, gather=True),
       dict(q=0.5, gather=True, gather_cap=0), dict(q=0.5, gather_cap=5)]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_cohort_spec_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        JaxCohort(**kw)
    with pytest.raises(ValueError) as terr:
        CohortSpec(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(), dict(q=1.0), dict(q=0.1), dict(q=0.37, gather=True),
                                dict(size=7), dict(size=90), dict(size=5, replace=True),
                                dict(q=0.2, gather=True, gather_cap=9),
                                dict(q=0.2, gather=True, gather_cap=900)])
@pytest.mark.parametrize("m", [1, 40, 1000])
def test_cap_rate_and_is_sampled_equal_jax(kw, m):
    j, t = JaxCohort(**kw), CohortSpec(**kw)
    assert t.is_sampled == j.is_sampled
    assert t.resolved_cap(m) == j.resolved_cap(m)
    assert t.sampling_rate(m) == j.sampling_rate(m)


def test_round_mask_samplers_statistically():
    m, rounds = 1000, 200
    bern, fixed, repl = CohortSpec(q=0.1), CohortSpec(size=100), CohortSpec(size=100,
                                                                           replace=True)
    total, per_client_fixed = 0.0, torch.zeros(m)
    for t in range(rounds):
        mb = bern.round_mask(round_generator(0, t), m)
        assert mb.dtype == torch.float32 and set(mb.unique().tolist()) <= {0.0, 1.0}
        total += float(mb.sum())
        mf = fixed.round_mask(round_generator(0, t), m)
        assert float(mf.sum()) == 100.0 and set(mf.unique().tolist()) <= {0.0, 1.0}
        per_client_fixed += mf
        mr = repl.round_mask(round_generator(0, t), m)
        assert float(mr.sum()) == 100.0 and torch.equal(mr, mr.round()) and mr.min() >= 0
    sd = math.sqrt(m * rounds * 0.1 * 0.9)
    assert abs(total - 0.1 * m * rounds) < 6 * sd        # Bernoulli(q) rate
    # each client in a fixed-size cohort 20 times in expectation (hypergeometric)
    assert abs(float(per_client_fixed.mean()) - 20.0) < 1e-9
    assert float(per_client_fixed.std()) < 3 * math.sqrt(20.0)
    a, b = (bern.round_mask(round_generator(3, 1), m) for _ in range(2))
    assert torch.equal(a, b)                              # the round's generator decides


# ---------------------------------------------------------------------------
# gather_slots, gather_rows, mask_rows
# ---------------------------------------------------------------------------

MASKS = {
    "bernoulli": (np.random.default_rng(1).random(40) < 0.3).astype(np.float32),
    "multiplicity": np.random.default_rng(2).integers(0, 3, 40).astype(np.float32),
    "empty": np.zeros(40, np.float32),
    "full": np.ones(40, np.float32),
}


@pytest.mark.parametrize("cap", [1, 7, 12, 40])
@pytest.mark.parametrize("kind", list(MASKS))
def test_gather_slots_equal_jax(kind, cap):
    mask = MASKS[kind]
    js, jm, jo = jlocal.gather_slots(jnp.asarray(mask), cap)
    ts, tm, to = gather_slots(torch.tensor(mask), cap)
    assert ts.dtype == torch.int64 and tm.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert to == float(jo)


def test_gather_rows_and_mask_rows_equal_jax():
    rng = np.random.default_rng(4)
    tree = {"x": rng.standard_normal((40, 3, 5)).astype(np.float32),
            "y": rng.standard_normal((40, 3)).astype(np.float32)}
    slots = np.array([3, 9, 0, 0], np.int64)
    got = gather_rows({k: torch.tensor(v) for k, v in tree.items()}, torch.tensor(slots))
    want = jlocal.gather_rows({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(slots))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    deltas = rng.standard_normal((40, 6)).astype(np.float32)
    mask = MASKS["bernoulli"]
    deltas[mask == 0] = np.nan
    np.testing.assert_array_equal(mask_rows(torch.tensor(deltas), torch.tensor(mask)).numpy(),
                                  np.asarray(jlocal.mask_rows(jnp.asarray(deltas),
                                                              jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# One sampled round of every name against JAX's _round_step
# ---------------------------------------------------------------------------

COHORTS = {"bernoulli": dict(q=0.3), "gathered": dict(q=0.3, gather=True),
           "fixed": dict(size=12), "replace": dict(size=12, replace=True)}
# every name under the first three; with replacement one name per mechanism
ROUND_CASES = ([(n, c) for n in COMPOSED for c in ("bernoulli", "gathered", "fixed")]
               + [(n, "replace") for n in ("fedexp", "ldp-fedexp-gauss", "cdp-fedexp",
                                           "ldp-fedexp-privunit", "ldp-fedexp-perclient")])


@pytest.mark.parametrize("name,cohort", ROUND_CASES)
def test_sampled_round_matches_jax_round_step(name, cohort, data):
    kw = algo_kwargs(name)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    jcoh, tcoh = JaxCohort(**COHORTS[cohort]), CohortSpec(**COHORTS[cohort])
    rng = np.random.default_rng(31)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    t, key = 2, jax.random.PRNGKey(60)
    batches = {"x": data["x"], "y": data["y"]}
    step = _round_step(jalg, jlocal.build_cohort_local_fn(jax_loss, None, TAU), None, 1,
                       cohort=jcoh, tau=TAU)
    jw, jstate, jouts = step(jnp.asarray(w), jalg.init_state(jnp.asarray(w)), key, t,
                             {k: jnp.asarray(v) for k, v in batches.items()}, ETA_L)
    mask = torch.tensor(np.asarray(jcoh.round_mask(key, M)))
    assert float(mask.sum()) > 0

    def local_fn(w_, b, eta):
        return cohort_updates(linreg_loss, w_, b, TAU, eta)

    if "adaptive-clip" in name:   # the clip bit is a float32 decision in both packages
        norms = np.linalg.norm(np.asarray(local_fn(torch.tensor(w), {
            k: torch.tensor(v) for k, v in batches.items()}, ETA_L)), axis=1)
        assert np.min(np.abs(norms - kw["c0"])) > 1e-4 * kw["c0"]
    inp = stage_inputs(talg, local_fn, round_noise_of(jalg, key, M, D, t), t, M, "cpu",
                       cohort=tcoh, mask=mask)
    tw, aux, tstate = masked_round(talg, local_fn, torch.tensor(w), talg.init_state(
        torch.tensor(w)), inp, tcoh, t, {k: torch.tensor(v) for k, v in batches.items()}, ETA_L)
    close(aux.eta_g, jouts[0], what="eta_g")
    for f, j in zip(("eta_naive", "eta_target"), jouts[2:]):
        g = float(getattr(aux, f))
        assert math.isnan(g) == math.isnan(float(j)), f
        if not math.isnan(g):
            close(g, j, what=f)
    close_vec(tw.numpy(), jw)
    if "adaptive-clip" in name:
        close(tstate.clip, jstate.clip, what="clip")


def test_an_empty_bernoulli_round_is_a_zero_update(data):
    """The clamped count: an empty cohort leaves w where it was, not NaN."""
    for name in ("ldp-fedexp-gauss", "cdp-fedexp", "fedavg", "ldp-fedexp-perclient"):
        alg = make_algorithm(name, **algo_kwargs(name))
        w = torch.full((D,), 0.25)
        noise = alg.stage_noise(alg.draw_noise(round_generator(0, 0), M, D, "cpu"), "cpu")
        if name == "cdp-fedexp":
            noise.central = torch.zeros(D)
        local_fn = lambda w_, b, eta: cohort_updates(linreg_loss, w_, b, TAU, eta)  # noqa: E731
        cohort = CohortSpec(q=0.3)
        inp = stage_inputs(alg, local_fn, noise, 0, M, "cpu", cohort=cohort, mask=torch.zeros(M))
        w_next, aux, _ = masked_round(alg, local_fn, w, alg.init_state(w), inp, cohort, 0,
                                      {k: torch.tensor(data[k]) for k in ("x", "y")}, ETA_L)
        assert torch.isfinite(w_next).all() and torch.equal(w_next, w), name


# ---------------------------------------------------------------------------
# Sessions: gathered = dense, CohortSpec() = full participation
# ---------------------------------------------------------------------------

def _session(name, data, cohort, rounds=ROUNDS):
    return FederatedSession(make_algorithm(name, **algo_kwargs(name)), linreg_loss,
                            np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            cohort=cohort, eval_fn=distance_to_opt(torch.tensor(
                                data["w_star"])), device="cpu")


@pytest.mark.parametrize("kind", ["bernoulli", "fixed"])
@pytest.mark.parametrize("name", COMPOSED)
def test_gathered_sessions_equal_dense_ones(name, kind, data):
    spec = dict(q=0.3) if kind == "bernoulli" else dict(size=12)
    dense = _session(name, data, CohortSpec(**spec)).run(3)
    gathered = _session(name, data, CohortSpec(**spec, gather=True)).run(3)
    close_vec(gathered.final_w.numpy(), dense.final_w.numpy())
    close_vec(gathered.eta_history.numpy(), dense.eta_history.numpy())
    assert torch.isfinite(dense.final_w).all()


@pytest.mark.parametrize("name", COMPOSED)
def test_unsampled_cohorts_are_full_participation_bit_for_bit(name, data):
    full = _session(name, data, None).run(5)
    for spec in (CohortSpec(), CohortSpec(q=1.0)):
        r = _session(name, data, spec).run(5)
        assert torch.equal(r.final_w, full.final_w) and torch.equal(r.eta_history,
                                                                     full.eta_history)


def test_session_refuses_a_cohort_larger_than_m(data):
    with pytest.raises(ValueError, match="exceeds the 40-client cohort"):
        _session("fedavg", data, CohortSpec(size=41))
    _session("fedavg", data, CohortSpec(size=41, replace=True))   # with replacement: fine


# ---------------------------------------------------------------------------
# The privacy report under sampling
# ---------------------------------------------------------------------------

PRIVATE = [n for n in COMPOSED if n not in ("fedavg", "fedexp")]


@pytest.mark.parametrize("spec", [dict(q=0.1), dict(size=7), dict(q=0.25, gather=True), {}])
@pytest.mark.parametrize("name", PRIVATE)
def test_privacy_report_under_sampling_equals_jax(name, spec, data):
    kw = algo_kwargs(name)
    js = JaxSession(jax_make(name, **kw), jax_loss, jnp.zeros(D),
                    {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                    cohort=JaxCohort(**spec))
    ts = _session(name, data, CohortSpec(**spec))
    want, got = js.privacy_report(1e-5), ts.privacy_report(1e-5)
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is b, f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f)
