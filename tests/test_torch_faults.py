"""The port's fault model, divergence watchdog and rollback against the JAX
package's, on the CPU.

``FaultSpec`` (validation, ``injects`` / ``is_active``), each function of
``fedsim/faults.py`` on the same inputs, the property ``apply_faults``
states in its docstring over seeded random blocks, the stragglers' step
cutoff of both local trainers, one faulted round of every registry name
against JAX's ``_round_step(..., fault=FAULT, tau=TAU)`` fed JAX's own fault
masks and noise (full participation, a gathered cohort and, for three
names, one drawn with replacement), ``FaultSpec()``
bit for bit with the fault-free session for every name, the watchdog (an
``eta_max`` trip against JAX's eager engine, NaN histories after it), and
rollback: a recovered run equal to the unkilled one in bits, retry
exhaustion, and the retried rounds and the realized participation in
``privacy_report`` against JAX at rtol 1e-12.  Float32 at rtol 1e-5 (a
vector's atol 1e-5 times its largest entry).
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
from repro.fedsim import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim import EngineSpec as JaxEngine  # noqa: E402
from repro.fedsim import FaultSpec as JaxFault  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import LocalSpec as JaxLocal  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import faults as jfaults  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.server import _round_step  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.core.aggregation import RoundMoments  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    FaultSpec,
    FederatedSession,
    LocalSpec,
    RecoveryPolicy,
    TrainSpec,
    cohort_updates,
    cohort_updates_scaffold,
    local_update,
    local_update_scaffold,
)
from repro_torch.fedsim import faults as tfaults  # noqa: E402
from repro_torch.fedsim.server import masked_round, stage_inputs  # noqa: E402
from repro_torch.fedsim.specs import FAULT_TAG  # noqa: E402
from test_torch_moments import algo_kwargs, close, close_vec, round_noise_of  # noqa: E402
from test_torch_scaffold import noise_of as scaffold_noise_of  # noqa: E402

M, D, TAU, ETA_L, ROUNDS = 44, 24, 3, 0.1, 5
# the JAX tests' acceptance fault model: 30% dropout, stragglers cut to 1 of
# tau steps and 2% corrupted (NaN) updates, every class at once
FAULT_KW = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.02)
FAULT = FaultSpec(**FAULT_KW)
NAMES = list_algorithms()
# a round key whose draws hold a dropout, a straggler and a corrupted client
# that is alive, in the full cohort and among the sampled clients of GATHERED
KEY = 61
GATHERED = dict(q=0.5, gather=True, gather_cap=24)


def kwargs(name):
    """make_algorithm kwargs of ``name`` at M clients (dp-scaffold's CDP mode
    at the paper's sigma = 5C/sqrt(M), as the JAX fault tests run it)."""
    if name == "dp-scaffold":
        return dict(clip_norm=0.3, sigma=5 * 0.3 / math.sqrt(M), central=True, num_clients=M,
                    tau=TAU, eta_l=ETA_L)
    return algo_kwargs(name, m=M, d=D)


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(3), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def tbatches(data):
    return {k: torch.tensor(data[k]) for k in ("x", "y")}


def jbatches(data):
    return {k: jnp.asarray(data[k]) for k in ("x", "y")}


def session(data, name, fault=FAULT, rounds=ROUNDS, alg=None, **kw):
    return FederatedSession(alg or make_algorithm(name, **kwargs(name)), linreg_loss,
                            np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                            else None, fault=fault,
                            eval_fn=distance_to_opt(torch.tensor(data["w_star"])),
                            device="cpu", **kw)


def same(a, b):
    """Equal results, NaN where both are NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


def assert_same_run(got, want):
    for f in FIELDS:
        assert same(getattr(got, f), getattr(want, f)), f
    assert got.fault_round == want.fault_round


# ---------------------------------------------------------------------------
# FaultSpec
# ---------------------------------------------------------------------------

BAD = [dict(dropout=1.0), dict(dropout=-0.1), dict(straggler=1.0), dict(straggler=-0.1),
       dict(corrupt=1.0), dict(corrupt=-0.1), dict(straggler_steps=0), dict(eta_max=0.0)]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_fault_spec_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        JaxFault(**kw)
    with pytest.raises(ValueError) as terr:
        FaultSpec(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(), dict(dropout=0.1), dict(straggler=0.2),
                                dict(corrupt=0.05), dict(watchdog=True),
                                dict(watchdog=True, eta_max=2.0), FAULT_KW])
def test_injects_and_is_active_equal_jax(kw):
    j, t = JaxFault(**kw), FaultSpec(**kw)
    assert (t.injects, t.is_active) == (j.injects, j.is_active)
    assert FAULT_TAG == 2**31 - 3


def test_recovery_policy_validates():
    with pytest.raises(ValueError, match="max_retries"):
        RecoveryPolicy(max_retries=0)
    with pytest.raises(ValueError, match="backoff"):
        RecoveryPolicy(backoff=-1.0)


# ---------------------------------------------------------------------------
# fedsim/faults.py
# ---------------------------------------------------------------------------

def test_fault_masks_are_keyed_by_the_round_and_class():
    spec = FaultSpec(dropout=0.3, straggler=0.2, corrupt=0.1)
    s0, s1 = round_generator(0, 0).initial_seed(), round_generator(0, 1).initial_seed()
    a = tfaults.fault_masks(spec, s0, 64)
    b = tfaults.fault_masks(spec, s0, 64)
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)
        assert set(x.unique().tolist()) <= {0.0, 1.0}
    assert not torch.equal(a[0], tfaults.fault_masks(spec, s1, 64)[0])
    # each class keeps its own draw whatever the other rates are
    alone = tfaults.fault_masks(FaultSpec(corrupt=0.1), s0, 64)
    assert alone[0] is None and alone[1] is None and torch.equal(alone[2], a[2])


def test_disabled_classes_draw_nothing_and_the_round_generator_is_untouched():
    gen = round_generator(5, 2)
    alive, strag, corrupt = tfaults.fault_masks(FaultSpec(dropout=0.5), gen.initial_seed(), 32)
    assert strag is None and corrupt is None
    # drawing the faults leaves the round's own stream (mask, noise) where it was
    want = torch.rand(8, generator=round_generator(5, 2))
    assert torch.equal(torch.rand(8, generator=gen), want)


def test_fault_rates_statistically():
    spec = FaultSpec(dropout=0.3, straggler=0.2, corrupt=0.05)
    draws = [tfaults.fault_masks(spec, round_generator(0, t).initial_seed(), 400)
             for t in range(32)]
    for i, rate in enumerate((0.7, 0.2, 0.05)):
        x = torch.stack([d[i] for d in draws])
        assert abs(float(x.mean()) - rate) < 5 * math.sqrt(rate * (1 - rate) / x.numel())


def test_gather_fault_rows_equal_jax():
    rng = np.random.default_rng(0)
    vecs = [(rng.random(M) < 0.4).astype(np.float32) for _ in range(2)]
    slots = np.array([3, 9, 0, 41, 0, 0], np.int64)
    got = tfaults.gather_fault_rows(torch.tensor(slots), torch.tensor(vecs[0]), None,
                                    torch.tensor(vecs[1]))
    want = jfaults.gather_fault_rows(jnp.asarray(slots), jnp.asarray(vecs[0]), None,
                                     jnp.asarray(vecs[1]))
    assert got[1] is None and want[1] is None
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cut,tau", [(1, 3), (2, 3), (3, 3), (7, 3), (1, 1)])
def test_resolve_steps_equal_jax(cut, tau):
    strag = np.array([1.0, 0.0, 1.0, 0.0, 0.0], np.float32)
    spec = dict(straggler=0.5, straggler_steps=cut)
    got = tfaults.resolve_steps(FaultSpec(**spec), torch.tensor(strag), tau)
    want = jfaults.resolve_steps(JaxFault(**spec), jnp.asarray(strag), tau)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def garbage_block(rng, m=9, d=5):
    """Rows with NaN, +-Inf, huge and ordinary entries, and masks of each kind."""
    x = rng.standard_normal((m, d)).astype(np.float32)
    for i in range(m):
        kind = rng.integers(0, 5)
        j = rng.integers(0, d)
        x[i, j] = (np.nan, np.inf, -np.inf, 3e38, x[i, j])[kind]
    mask = (rng.random(m) < 0.7).astype(np.float32)
    alive = (rng.random(m) < 0.7).astype(np.float32)
    corrupt = (rng.random(m) < 0.3).astype(np.float32)
    return x, mask, alive, corrupt


@pytest.mark.parametrize("classes", ["both", "alive", "corrupt", "neither"])
def test_inject_corruption_finite_rows_and_apply_faults_equal_jax(classes):
    rng = np.random.default_rng(1)
    x, mask, alive, corrupt = garbage_block(rng)
    alive = alive if classes in ("both", "alive") else None
    corrupt = corrupt if classes in ("both", "corrupt") else None
    t = lambda v: None if v is None else torch.tensor(v)  # noqa: E731
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    got_d, got_m = tfaults.apply_faults(t(x), t(mask), t(alive), t(corrupt))
    want_d, want_m = jfaults.apply_faults(j(x), j(mask), j(alive), j(corrupt))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if corrupt is not None:
        np.testing.assert_array_equal(
            tfaults.inject_corruption(t(x), t(corrupt)).numpy(),
            np.asarray(jfaults.inject_corruption(j(x), j(corrupt))))
    np.testing.assert_array_equal(tfaults.finite_rows(t(x)).numpy(),
                                  np.asarray(jfaults.finite_rows(j(x))))


@pytest.mark.parametrize("seed", range(40))
def test_apply_faults_keeps_its_docstring_contract(seed):
    """``apply_faults``' stated property on seeded random blocks: every row it
    returns is finite; a row is on in the effective mask only where it was on
    in the mask, alive, not corrupted and finite (its mask value kept);
    every row that is off is zero and every row that is on unchanged."""
    rng = np.random.default_rng(seed)
    x, mask, alive, corrupt = garbage_block(rng, m=int(rng.integers(1, 12)),
                                            d=int(rng.integers(1, 7)))
    mask = mask * rng.integers(1, 3, mask.shape).astype(np.float32)   # multiplicities too
    out, eff = tfaults.apply_faults(torch.tensor(x), torch.tensor(mask), torch.tensor(alive),
                                    torch.tensor(corrupt))
    out, eff = out.numpy(), eff.numpy()
    assert np.isfinite(out).all()
    ok = (mask > 0) & (alive > 0) & (corrupt == 0) & np.isfinite(x).all(axis=1)
    np.testing.assert_array_equal(eff, np.where(ok, mask, 0.0))
    np.testing.assert_array_equal(out[~ok], 0.0)
    np.testing.assert_array_equal(out[ok], x[ok])


def test_sanitize_moments_equals_jax():
    sum_c = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    mom = RoundMoments(sum_c=torch.tensor(sum_c), sum_sq=torch.tensor(float("inf")),
                       sum_sq_clipped=torch.tensor(3.0), count=torch.tensor(float("nan")))
    extras = {"count_below": torch.tensor(2.0), "n": torch.tensor(3, dtype=torch.int32),
              "scalar": float("inf")}
    got_m, got_e = tfaults.sanitize_moments((mom, extras))
    want = jfaults.sanitize_moments({"sum_c": jnp.asarray(sum_c), "sum_sq": jnp.float32(np.inf),
                                     "count": jnp.float32(np.nan), "n": jnp.int32(3)})
    np.testing.assert_array_equal(got_m.sum_c.numpy(), np.asarray(want["sum_c"]))
    assert float(got_m.sum_sq) == float(want["sum_sq"]) == 0.0
    assert float(got_m.count) == float(want["count"]) == 0.0
    assert float(got_m.sum_sq_clipped) == 3.0 and float(got_e["count_below"]) == 2.0
    assert got_e["n"].dtype == torch.int32 and int(got_e["n"]) == int(want["n"]) == 3
    assert got_e["scalar"] == 0.0
    clean = RoundMoments(sum_c=torch.ones(3), sum_sq=torch.tensor(1.0),
                         sum_sq_clipped=torch.tensor(1.0), count=4.0)
    again = tfaults.sanitize_moments(clean)
    assert torch.equal(again.sum_c, clean.sum_c) and again.count == 4.0


# ---------------------------------------------------------------------------
# The stragglers' cutoff in both trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [0, 1, 2, TAU, TAU + 2])
def test_local_update_steps_equal_jax(steps, data):
    w = (0.3 * np.random.default_rng(2).standard_normal(D)).astype(np.float32)
    one = {k: data[k][0] for k in ("x", "y")}
    got = local_update(linreg_loss, torch.tensor(w), {k: torch.tensor(v) for k, v in one.items()},
                       TAU, ETA_L, steps=torch.tensor(steps, dtype=torch.int32))
    want = jlocal.local_update(jax_loss, jnp.asarray(w), {k: jnp.asarray(v) for k, v in
                                                          one.items()}, TAU, ETA_L,
                               steps=jnp.int32(steps))
    close_vec(got.numpy(), want)
    if steps >= TAU:   # the uncut loop, bit for bit
        full = local_update(linreg_loss, torch.tensor(w), {k: torch.tensor(v) for k, v in
                                                           one.items()}, TAU, ETA_L)
        assert torch.equal(got, full)


def test_cohort_updates_per_client_steps_equal_jax(data):
    rng = np.random.default_rng(3)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    steps = rng.integers(0, TAU + 1, M).astype(np.int32)
    got = cohort_updates(linreg_loss, torch.tensor(w), tbatches(data), TAU, ETA_L,
                         steps=torch.tensor(steps))
    want = jlocal.cohort_updates(jax_loss, jnp.asarray(w), jbatches(data), TAU, ETA_L,
                                 steps=jnp.asarray(steps))
    close_vec(got.numpy(), want)
    assert torch.equal(got[steps == 0], torch.zeros(int((steps == 0).sum()), D))


def test_scaffold_trainer_steps_equal_jax(data):
    rng = np.random.default_rng(4)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    c = (0.1 * rng.standard_normal(D)).astype(np.float32)
    c_is = (0.1 * rng.standard_normal((M, D))).astype(np.float32)
    steps = rng.integers(0, TAU + 1, M).astype(np.int32)
    got = cohort_updates_scaffold(linreg_loss, torch.tensor(w), tbatches(data), TAU, ETA_L,
                                  (torch.tensor(c_is), torch.tensor(c)),
                                  steps=torch.tensor(steps))
    want = jlocal.cohort_updates_scaffold(jax_loss, jnp.asarray(w), jbatches(data), TAU, ETA_L,
                                          (jnp.asarray(c_is), jnp.asarray(c)),
                                          steps=jnp.asarray(steps))
    close_vec(got.numpy(), want)
    one = {k: torch.tensor(data[k][5]) for k in ("x", "y")}
    cut = local_update_scaffold(linreg_loss, torch.tensor(w), one, torch.tensor(c_is[5]),
                                torch.tensor(c), TAU, ETA_L, steps=torch.tensor(TAU))
    assert torch.equal(cut, local_update_scaffold(linreg_loss, torch.tensor(w), one,
                                                  torch.tensor(c_is[5]), torch.tensor(c),
                                                  TAU, ETA_L))


# ---------------------------------------------------------------------------
# One faulted round of every name against JAX's _round_step
# ---------------------------------------------------------------------------

def _jax_state(jalg, w, name, rng):
    """JAX's init state, with a planted variate carry for dp-scaffold (so a
    failed row's dc would be -c were it not gated)."""
    state = jalg.init_state(jnp.asarray(w))
    if name != "dp-scaffold":
        return state, None
    c = (0.1 * rng.standard_normal(D)).astype(np.float32)
    c_is = (0.1 * rng.standard_normal((M, D))).astype(np.float32)
    return type(state)(c=jnp.asarray(c), c_is=jnp.asarray(c_is)), (c, c_is)


# every name under full participation and gathered; a cohort drawn with
# replacement (multiplicities) for one name of each kind of masked release
ROUND_CASES = ([(n, c) for n in NAMES for c in ("full", "gathered")]
               + [(n, "replace") for n in ("ldp-fedexp-gauss", "cdp-fedexp", "dp-scaffold")])
COHORTS = {"full": None, "gathered": GATHERED, "replace": dict(size=30, replace=True)}


@pytest.mark.parametrize("name,cohort", ROUND_CASES)
def test_faulted_round_matches_jax_round_step(name, cohort, data):
    """One round under FAULT through the port's masked-moment round, fed
    JAX's fault masks, cohort mask and noise, against JAX's ``_round_step``."""
    _faulted_round_against_jax(name, cohort, data)


@pytest.mark.parametrize("name,cohort", [("dp-scaffold", "replace"), ("dp-scaffold", "full"),
                                         ("ldp-fedexp-gauss", "replace")])
def test_a_client_that_diverges_unplanted_is_screened_as_in_jax(name, cohort, data):
    """A drawn, alive, uncorrupted client whose data makes its local update
    overflow (no fault planted it) is turned off by the finite screen on the
    device alone: its drawn rows add no noise and no count, as JAX's
    effective mask excludes them."""
    key = jax.random.PRNGKey(KEY)
    alive, _, corrupt = (np.asarray(v) for v in jfaults.fault_masks(JaxFault(**FAULT_KW),
                                                                      key, M))
    spec = COHORTS[cohort]
    drawn = np.ones(M) if spec is None else np.asarray(JaxCohort(**spec).round_mask(key, M))
    i = int(np.flatnonzero((drawn > 0) & (alive > 0) & (corrupt == 0))[0])
    x = data["x"].copy()
    x[i] *= 1e20
    _faulted_round_against_jax(name, cohort, {**data, "x": x}, diverged=i)


def _faulted_round_against_jax(name, cohort, data, diverged=None):
    """The round of ``test_faulted_round_matches_jax_round_step``; with
    ``diverged``, that client's update is also checked to be non-finite."""
    kw = kwargs(name)
    jalg, talg = jax_make(name, **kw), make_algorithm(name, **kw)
    scaffold = name == "dp-scaffold"
    spec = COHORTS[cohort]
    jcoh = None if spec is None else JaxCohort(**spec)
    tcoh = None if spec is None else CohortSpec(**spec)
    rng = np.random.default_rng(31)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    t, key = 2, jax.random.PRNGKey(KEY)
    jstate, planted = _jax_state(jalg, w, name, rng)
    tstate = talg.init_state(torch.tensor(w))
    if planted is not None:
        tstate = type(tstate)(c=torch.tensor(planted[0]), c_is=torch.tensor(planted[1]))
    local_j = jlocal.build_cohort_local_fn(jax_loss, JaxLocal(control_variates=True)
                                           if scaffold else None, TAU, with_steps=True)
    step = _round_step(jalg, local_j, None, 1, cohort=jcoh, fault=JaxFault(**FAULT_KW), tau=TAU)
    jw, jstate2, jouts = step(jnp.asarray(w), jstate, key, t, jbatches(data), ETA_L)

    faults = tuple(torch.tensor(np.asarray(v)) for v in
                   jfaults.fault_masks(JaxFault(**FAULT_KW), key, M))
    mask = (torch.ones(M) if jcoh is None else torch.tensor(np.asarray(jcoh.round_mask(key, M))))
    noise = scaffold_noise_of(jalg, key, M, D) if scaffold else round_noise_of(jalg, key, M, D, t)

    def local_fn(w_, b, eta, *ctx, steps=None):
        if ctx:
            return cohort_updates_scaffold(linreg_loss, w_, b, TAU, eta, *ctx, steps=steps)
        return cohort_updates(linreg_loss, w_, b, TAU, eta, steps=steps)

    if "adaptive-clip" in name:   # the clip bit is a float32 decision in both packages
        steps = tfaults.resolve_steps(FAULT, faults[1], TAU)
        norms = np.linalg.norm(local_fn(torch.tensor(w), tbatches(data), ETA_L,
                                        steps=steps).numpy(), axis=1)
        assert np.min(np.abs(norms - kw["c0"])) > 1e-4 * kw["c0"]
    if diverged is not None:
        upd = local_fn(torch.tensor(w), tbatches(data), ETA_L,
                       *(talg.local_context(tstate, 0, M),) if scaffold else ())
        assert not torch.isfinite(upd[diverged]).all()
    inp = stage_inputs(talg, local_fn, noise, t, M, "cpu", cohort=tcoh, fault=FAULT, mask=mask,
                       faults=faults)
    tw, aux, tstate2 = masked_round(talg, local_fn, torch.tensor(w), tstate, inp, tcoh, t,
                                    tbatches(data), ETA_L, fault=FAULT, tau=TAU)
    assert torch.isfinite(tw).all()
    close(aux.eta_g, jouts[0], what="eta_g")
    for f, j in zip(("eta_naive", "eta_target"), jouts[2:]):
        g = float(getattr(aux, f))
        assert math.isnan(g) == math.isnan(float(j)), f
        if not math.isnan(g):
            close(g, j, what=f)
    close_vec(tw.numpy(), jw)
    if "adaptive-clip" in name:
        close(tstate2.clip, jstate2.clip, what="clip")
    if scaffold:
        close_vec(tstate2.c.numpy(), jstate2.c)
        close_vec(tstate2.c_is.numpy(), jstate2.c_is)


def test_the_round_key_holds_every_fault_class():
    """KEY draws a dropout, a straggler and an alive corrupted client, in the
    full cohort and among GATHERED's sampled clients within its cap."""
    key = jax.random.PRNGKey(KEY)
    alive, strag, corrupt = (np.asarray(v) for v in
                             jfaults.fault_masks(JaxFault(**FAULT_KW), key, M))
    on = np.asarray(JaxCohort(**GATHERED).round_mask(key, M)) > 0
    assert (alive == 0).any() and ((strag > 0) & (alive > 0) & on).any()
    assert ((corrupt > 0) & (alive > 0) & on).any()
    assert on.sum() <= GATHERED["gather_cap"]


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_default_fault_spec_is_the_fault_free_run_bit_for_bit(name, data):
    clean = session(data, name, fault=None).run(11)
    assert_same_run(session(data, name, fault=FaultSpec()).run(11), clean)
    assert session(data, name, fault=FaultSpec()).fault is None


@pytest.mark.parametrize("name", ["ldp-fedexp-gauss", "cdp-fedexp", "dp-scaffold",
                                  "cdp-fedexp-adaptive-clip"])
def test_faulted_run_is_deterministic_finite_and_differs_from_clean(name, data):
    a, b = session(data, name).run(9), session(data, name).run(9)
    assert_same_run(a, b)
    assert torch.isfinite(a.final_w).all() and torch.isfinite(a.eta_history).all()
    clean = session(data, name, fault=None).run(9)
    assert not torch.allclose(a.final_w, clean.final_w)


def test_faults_compose_with_sampling_and_gather(data):
    dense = session(data, "cdp-fedexp", cohort=CohortSpec(q=0.6)).run(5)
    gathered = session(data, "cdp-fedexp", cohort=CohortSpec(q=0.6, gather=True)).run(5)
    assert torch.isfinite(dense.final_w).all()
    close_vec(gathered.final_w.numpy(), dense.final_w.numpy())
    close_vec(gathered.eta_history.numpy(), dense.eta_history.numpy())


def test_near_total_dropout_stays_finite(data):
    """dropout 0.99 empties rounds: the clamped realized count makes each a
    zero update, never NaN."""
    spec = FaultSpec(dropout=0.99)
    empty = [float(tfaults.fault_masks(spec, round_generator(0, t).initial_seed(), M)[0].sum())
             == 0.0 for t in range(8)]
    assert any(empty)
    for name in ("fedavg", "ldp-fedexp-gauss", "cdp-fedexp", "dp-scaffold"):
        r = session(data, name, fault=spec, rounds=8).run(0)
        assert torch.isfinite(r.final_w).all() and torch.isfinite(r.eta_history).all(), name


def test_heavy_corruption_keeps_the_model_finite(data):
    for name in ("fedavg", "ldp-fedexp-gauss", "cdp-fedexp", "dp-fedadam-cdp",
                 "cdp-fedexp-adaptive-clip", "privunit-fedexp-adaptive-clip"):
        r = session(data, name, fault=FaultSpec(dropout=0.6, corrupt=0.5), rounds=2).run(17)
        assert torch.isfinite(r.final_w).all() and torch.isfinite(r.eta_history).all(), name


def test_run_batched_and_recovery_refuse_what_jax_refuses(data, tmp_path):
    with pytest.raises(ValueError, match="fault"):
        session(data, "fedavg", fault=FaultSpec(dropout=0.1)).run_batched([0])
    policy = RecoveryPolicy(max_retries=1)
    with pytest.raises(ValueError, match="watchdog"):
        session(data, "fedavg", fault=FaultSpec()).run(0, checkpoint_dir=str(tmp_path),
                                                       on_divergence=policy)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        session(data, "fedavg", fault=FaultSpec(watchdog=True)).run(0, on_divergence=policy)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        session(data, "fedavg").run(0, checkpoint_every=2)


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------

def test_eta_max_trip_matches_jax_eager(data):
    """fedexp's eta_g >= 1, so eta_max 0.5 trips round 0 in both packages:
    the round is not committed (w stays w0), it records its real eta_g, and
    the rounds after it NaN."""
    spec = dict(watchdog=True, eta_max=0.5)
    js = JaxSession(jax_make("fedexp"), jax_loss, jnp.zeros(D), jbatches(data),
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                    engine=JaxEngine(engine="eager"), fault=JaxFault(**spec))
    want = js.run(jax.random.PRNGKey(3))
    got = session(data, "fedexp", fault=FaultSpec(**spec)).run(3)
    assert got.fault_round == want.fault_round == 0
    assert torch.equal(got.last_w, torch.zeros(D)) and torch.equal(got.final_w, torch.zeros(D))
    close(got.eta_history[0], np.asarray(want.eta_history)[0])   # fedexp draws no noise
    assert float(got.eta_history[0]) > 0.5
    for f in ("eta_history", "metric_history", "eta_naive_history", "eta_target_history"):
        assert torch.isnan(getattr(got, f)[1:]).all(), f
    assert [t for t, _ in got.eval_rounds()] == [0]    # the tripped round ran


def _poison(carry, attempt):
    """Attempt 0 runs from a model with an Inf coordinate, later ones clean."""
    if attempt > 0:
        return carry
    w = carry[0].clone()
    w[0] = float("inf")
    return (w,) + tuple(carry[1:])


def test_a_trip_mid_run_keeps_the_rounds_before_it(data):
    clean = session(data, "cdp-fedexp", fault=FaultSpec(watchdog=True)).run(11)
    assert clean.fault_round is None and torch.isfinite(clean.eta_history).all()
    s = session(data, "cdp-fedexp", fault=FaultSpec(watchdog=True))

    def late(carry, attempt):
        return carry

    s._inject_divergence = late
    assert_same_run(s.run(11), clean)      # the hook alone changes nothing
    s._inject_divergence = _poison
    r = s.run(11)
    assert r.fault_round == 0 and torch.isnan(r.eta_history[1:]).all()


def test_the_watchdog_alone_keeps_the_trajectory_bit_for_bit(data):
    for name in ("cdp-fedexp", "ldp-fedexp-gauss", "dp-scaffold"):
        clean = session(data, name, fault=None).run(11)
        watched = session(data, name, fault=FaultSpec(watchdog=True)).run(11)
        assert_same_run(watched, clean)


# ---------------------------------------------------------------------------
# Rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cdp-fedexp", "dp-scaffold"])
@pytest.mark.parametrize("faulty", [False, True], ids=["watchdog", "faults+watchdog"])
def test_rollback_equals_the_unkilled_run_bit_for_bit(name, faulty, data, tmp_path):
    spec = FaultSpec(**(FAULT_KW if faulty else {}), watchdog=True)
    want = session(data, name, fault=spec).run(11)
    s = session(data, name, fault=spec)
    s._inject_divergence = _poison
    got = s.run(11, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                on_divergence=RecoveryPolicy(max_retries=2))
    assert got.fault_round is None and s._rounds_retried == 1   # round 0 tripped, ran again
    assert_same_run(got, want)


def test_recovery_from_a_mid_run_checkpoint(data, tmp_path):
    """A divergence planted at round 3 of attempts 0 and 1: each rolls back to
    the checkpoint at round 2, the third attempt finishes the run."""
    spec = FaultSpec(watchdog=True)
    want = session(data, "cdp-fedexp", fault=spec).run(11)
    s = session(data, "cdp-fedexp", fault=spec)
    calls = []

    def poison_round_3(carry, attempt):
        calls.append(attempt)
        return carry

    real_step = s._step

    def step_with_poison():
        step = real_step()

        def poisoned(w, state, gen, t, batches, eta_l):
            if t == 3 and calls[-1] < 2:
                w = w.clone()
                w[1] = float("nan")
            return step(w, state, gen, t, batches, eta_l)
        return poisoned

    s._step = step_with_poison
    s._inject_divergence = poison_round_3
    got = s.run(11, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                on_divergence=RecoveryPolicy(max_retries=3))
    assert calls == [0, 1, 2] and got.fault_round is None
    assert s._rounds_retried == 2 * (3 + 1 - 2)
    assert_same_run(got, want)


def test_retry_exhaustion_surfaces_the_fault(data, tmp_path):
    s = session(data, "cdp-fedexp", fault=FaultSpec(watchdog=True))
    s._inject_divergence = lambda carry, attempt: _poison(carry, 0)
    r = s.run(0, checkpoint_dir=str(tmp_path), checkpoint_every=2,
              on_divergence=RecoveryPolicy(max_retries=2))
    assert r.fault_round == 0 and s._rounds_retried == 2
    assert torch.isnan(r.eta_history[1:]).all() and not torch.isfinite(r.last_w).all()


def test_a_tripped_carry_is_never_saved(data, tmp_path):
    session(data, "fedexp", fault=FaultSpec(watchdog=True, eta_max=0.5)).run(
        3, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert ckpt.checkpoint_steps(str(tmp_path)) == []


def _jax_report(data, name, retried, fault_kw=None, cohort=None):
    js = JaxSession(jax_make(name, **kwargs(name)), jax_loss, jnp.zeros(D), jbatches(data),
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                    local=JaxLocal(control_variates=name == "dp-scaffold"),
                    fault=JaxFault(**(fault_kw or {})),
                    cohort=JaxCohort(**(cohort or {})))
    js._rounds_retried = retried
    return js.privacy_report(1e-5)


def _reports_equal(got, want):
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is b, f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f)


@pytest.mark.parametrize("name", ["cdp-fedexp", "dp-fedavg-cdp", "dp-scaffold"])
def test_the_retried_rounds_join_the_privacy_report_as_in_jax(name, data, tmp_path):
    s = session(data, name, fault=FaultSpec(watchdog=True))
    base = s.privacy_report(1e-5)
    s._inject_divergence = _poison
    s.run(11, checkpoint_dir=str(tmp_path), checkpoint_every=2,
          on_divergence=RecoveryPolicy(max_retries=2))
    assert s._rounds_retried == 1
    got = s.privacy_report(1e-5)
    _reports_equal(got, _jax_report(data, name, 1, dict(watchdog=True)))
    assert got.eps_numerical > base.eps_numerical


@pytest.mark.parametrize("cohort", [None, dict(q=0.5), dict(size=11)])
@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss", "dp-scaffold"])
def test_the_report_composes_at_the_realized_participation_as_in_jax(name, cohort, data):
    s = session(data, name, cohort=None if cohort is None else CohortSpec(**cohort))
    _reports_equal(s.privacy_report(1e-5), _jax_report(data, name, 0, FAULT_KW, cohort))
