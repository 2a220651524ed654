"""The port's DP-SCAFFOLD against the JAX package's, on the CPU.

``LocalSpec`` validation, the control-variate trainer, ``local_context``,
the dense round and the masked-moment round (a Bernoulli mask, a fixed
cohort with replacement, a contiguous block and a gathered slot table with
padding), one sampled round through the round loop against JAX's
``_round_step``, whole sessions over 10 rounds in both modes, the legacy
``run_dp_scaffold`` loop against the session, ``run_batched`` against
``run``, the budget and the sampled privacy report, and the session's
refusals.  The port is fed the JAX round's own noise: the two halves of each
round key, as ``materialize_ldp_noise`` rows (LDP) or (d,) normals (CDP).
Float32 against JAX at rtol 1e-5 (a vector's atol 1e-5 times its largest
entry); the port against itself bit for bit; the accounting at 1e-12.
"""
import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.fedexp import list_algorithms as jax_list  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.core.variance_reduction import ScaffoldState as JaxState  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.server import _round_step  # noqa: E402
from repro.fedsim.specs import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim.specs import LocalSpec as JaxLocal  # noqa: E402
from repro_torch.core.algorithm import RoundNoise, round_generator  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.core.variance_reduction import DPScaffoldServer, ScaffoldState  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    FederatedSession,
    LocalSpec,
    TrainSpec,
    cohort_updates_scaffold,
    cohort_updates_spec,
    local_update_scaffold,
)
from repro_torch.fedsim import scaffold as tscaffold  # noqa: E402
from repro_torch.fedsim.server import sampled_round  # noqa: E402

M, D, TAU, ETA_L, C, ROUNDS = 40, 32, 5, 0.3, 0.3, 10
MODES = {"ldp": False, "cdp": True}


def close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def close(got, want, rtol=1e-5, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, err_msg=what)


def kwargs(mode, sigma_scale=1.0):
    """dp-scaffold's kwargs in the paper's protocol (benchmarks/e1_synthetic.py)."""
    central = MODES[mode]
    sigma = 5 * C / math.sqrt(M) if central else 0.7 * C
    return dict(clip_norm=C, sigma=sigma_scale * sigma, central=central, num_clients=M,
                tau=TAU, eta_l=ETA_L)


def noise_of(jalg, key, m=M, d=D) -> RoundNoise:
    """The JAX round's two releases' noise, as the port's RoundNoise, for all
    m clients (rows keyed by global client index)."""
    k_dy, k_dc = jax.random.split(key)
    if jalg.central:
        return RoundNoise(central=torch.tensor(np.asarray(jax.random.normal(k_dy, (d,)))),
                          central_dc=torch.tensor(np.asarray(jax.random.normal(k_dc, (d,)))))
    std = jalg.sigma * math.sqrt(2.0)
    return RoundNoise(
        ldp=torch.tensor(np.asarray(jagg.materialize_ldp_noise(k_dy, m, d, std))),
        ldp_dc=torch.tensor(np.asarray(jagg.materialize_ldp_noise(k_dc, m, d,
                                                                  std * jalg.variate_scale))))


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(0), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def jbatches(data):
    return {k: jnp.asarray(data[k]) for k in ("x", "y")}


def tbatches(data):
    return {k: torch.tensor(data[k]) for k in ("x", "y")}


def states(rng, m=M, d=D):
    """A planted carry: nonzero c and c_is (so a masked row's dc would be -c)."""
    c = (0.2 * rng.standard_normal(d)).astype(np.float32)
    c_is = (0.2 * rng.standard_normal((m, d))).astype(np.float32)
    return (JaxState(c=jnp.asarray(c), c_is=jnp.asarray(c_is)),
            ScaffoldState(c=torch.tensor(c), c_is=torch.tensor(c_is)))


def state_close(ts, js):
    close_vec(ts.c.numpy(), js.c)
    close_vec(ts.c_is.numpy(), js.c_is)


def raw_deltas(rng, m=M, d=D):
    """Rows with norms spread over [0.05, 2] C, some clipped, some not."""
    x = rng.standard_normal((m, d))
    norms = C * (0.05 + 1.95 * rng.random(m))
    return (x * (norms / np.linalg.norm(x, axis=1))[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# LocalSpec and the registry
# ---------------------------------------------------------------------------

LOCAL_SPECS = [dict(), dict(control_variates=True), dict(batch_size=0), dict(epochs=0),
               dict(epochs=2), dict(batch_size=4, epochs=2), dict(prox_mu=-0.1),
               dict(prox_mu=0.1), dict(momentum=1.0), dict(momentum=-0.1), dict(momentum=0.9),
               dict(control_variates=True, batch_size=4), dict(control_variates=True, epochs=2),
               dict(control_variates=True, prox_mu=0.1),
               dict(control_variates=True, momentum=0.5)]


@pytest.mark.parametrize("kw", LOCAL_SPECS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                                    kw.items()) or "default")
def test_local_spec_validates_as_jax(kw):
    try:
        want = JaxLocal(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            LocalSpec(**kw)
        assert str(got.value) == str(e)
        return
    got = LocalSpec(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_default == want.is_default


def test_the_registry_is_the_jax_registry():
    assert list_algorithms() == sorted(jax_list())
    alg = make_algorithm("dp-scaffold", **kwargs("cdp"))
    assert isinstance(alg, DPScaffoldServer) and alg.uses_local_context
    assert alg.variate_scale == jax_make("dp-scaffold", **kwargs("cdp")).variate_scale
    assert alg.comm_floats(D) == 2 * D + 3
    for bad in (dict(clip_norm=0.0), dict(sigma=-1.0), dict(num_clients=0), dict(tau=0),
                dict(eta_l=0.0)):
        with pytest.raises(ValueError) as want:
            jax_make("dp-scaffold", **{**kwargs("cdp"), **bad})
        with pytest.raises(ValueError) as got:
            make_algorithm("dp-scaffold", **{**kwargs("cdp"), **bad})
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="stateful"):
        alg.apply_round(None, torch.zeros(D), torch.zeros(M, D))


# ---------------------------------------------------------------------------
# The control-variate trainer and the local context
# ---------------------------------------------------------------------------

def test_local_update_scaffold_matches_jax(data):
    rng = np.random.default_rng(1)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    c_i = (0.2 * rng.standard_normal(D)).astype(np.float32)
    c = (0.2 * rng.standard_normal(D)).astype(np.float32)
    batch = {k: v[3] for k, v in data.items() if k in ("x", "y")}
    want = jlocal.local_update_scaffold(jax_loss, jnp.asarray(w), {k: jnp.asarray(v) for k, v
                                                                   in batch.items()},
                                        jnp.asarray(c_i), jnp.asarray(c), TAU, ETA_L)
    got = local_update_scaffold(linreg_loss, torch.tensor(w), {k: torch.tensor(v) for k, v in
                                                               batch.items()},
                                torch.tensor(c_i), torch.tensor(c), TAU, ETA_L)
    close_vec(got.numpy(), want)


def test_cohort_updates_scaffold_matches_jax_and_its_rows(data):
    rng = np.random.default_rng(2)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    js, ts = states(rng)
    want = jlocal.cohort_updates_scaffold(jax_loss, jnp.asarray(w), jbatches(data), TAU, ETA_L,
                                          (js.c_is, js.c))
    got = cohort_updates_scaffold(linreg_loss, torch.tensor(w), tbatches(data), TAU, ETA_L,
                                  (ts.c_is, ts.c))
    assert got.shape == (M, D)
    close_vec(got.numpy(), want)
    one = local_update_scaffold(linreg_loss, torch.tensor(w), {k: v[7] for k, v in
                                                               tbatches(data).items()},
                                ts.c_is[7], ts.c, TAU, ETA_L)
    close_vec(got[7].numpy(), one.numpy(), rtol=1e-6)


@pytest.mark.parametrize("start", ["zero", "block", "tail", "slots"])
def test_local_context_matches_jax(start):
    rng = np.random.default_rng(3)
    js, ts = states(rng)
    jalg, talg = jax_make("dp-scaffold", **kwargs("ldp")), make_algorithm("dp-scaffold",
                                                                          **kwargs("ldp"))
    if start == "slots":
        slots = np.array([1, 4, 39, 17, 0, 0], np.int64)
        jstart, tstart, m = jnp.asarray(slots, jnp.int32), torch.tensor(slots), 6
    else:
        jstart = tstart = {"zero": 0, "block": 8, "tail": 30}[start]
        m = M if start == "zero" else 16
    jrows, jc = jalg.local_context(js, jstart, m)
    trows, tc = talg.local_context(ts, tstart, m)
    assert torch.equal(trows, torch.tensor(np.asarray(jrows)))
    assert torch.equal(tc, ts.c)
    if start == "zero":
        assert trows is ts.c_is          # the table itself, no copy
    if start == "tail":
        assert not trows[10:].any()      # rows past the table are zeros


# ---------------------------------------------------------------------------
# The dense round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_dense_round_matches_jax(mode):
    rng = np.random.default_rng(4)
    jalg, talg = (jax_make("dp-scaffold", **kwargs(mode)),
                  make_algorithm("dp-scaffold", **kwargs(mode)))
    js, ts = states(rng)
    x = raw_deltas(rng)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jw, jaux, js2 = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x), js)
    tw, taux, ts2 = talg.apply_round_stateful(None, torch.tensor(w), torch.tensor(x), ts,
                                              noise_of(jalg, key))
    close_vec(tw.numpy(), jw)
    state_close(ts2, js2)
    assert float(taux.eta_g) == float(jaux.eta_g) == 1.0


# ---------------------------------------------------------------------------
# The masked-moment round
# ---------------------------------------------------------------------------

SLOTS = np.array([1, 4, 5, 9, 17, 22, 30, 38, 0, 0], np.int64)   # two padding slots


def block(kind, rng):
    """(JAX start, port start, mask, binary) of a block of clients."""
    if kind == "bernoulli":
        mask = (rng.random(M) < 0.4).astype(np.float32)
        mask[2] = 1.0
        return 0, 0, mask, True
    if kind == "replace":
        idx = rng.integers(0, M, 30)
        mask = np.bincount(idx, minlength=M).astype(np.float32)
        assert mask.max() >= 2            # duplicates
        return 0, 0, mask, False
    if kind == "contiguous":
        return 8, 8, (rng.random(M - 8) < 0.6).astype(np.float32), True
    if kind == "gathered-replace":
        mask = np.array([2, 1, 3, 1, 1, 2, 1, 1, 0, 0], np.float32)   # slot multiplicities
        return jnp.asarray(SLOTS, jnp.int32), torch.tensor(SLOTS), mask, False
    mask = np.array([1] * 8 + [0, 0], np.float32)
    return jnp.asarray(SLOTS, jnp.int32), torch.tensor(SLOTS), mask, True


@pytest.mark.parametrize("kind", ["bernoulli", "replace", "contiguous", "gathered",
                                  "gathered-replace"])
@pytest.mark.parametrize("mode", list(MODES))
def test_local_moments_and_apply_from_moments_match_jax(mode, kind):
    rng = np.random.default_rng(5)
    jalg, talg = (jax_make("dp-scaffold", **kwargs(mode)),
                  make_algorithm("dp-scaffold", **kwargs(mode)))
    js, ts = states(rng)
    jstart, tstart, mask, binary = block(kind, rng)
    m = mask.shape[0]
    idx = np.arange(tstart, tstart + m) if isinstance(tstart, int) else SLOTS
    x = raw_deltas(rng)[idx]
    x[mask == 0] = 0.0                    # the round zeroes left-out rows (mask_rows)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    noise = noise_of(jalg, key)
    jmom = jalg.local_moments(key, jnp.asarray(w), jnp.asarray(x), jnp.asarray(mask), jstart, js)
    tmom = talg.local_moments(noise, torch.tensor(w), torch.tensor(x), torch.tensor(mask),
                              tstart, ts, binary_mask=binary)
    close_vec(tmom[0].sum_c.numpy(), jmom[0].sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tmom[0], f), getattr(jmom[0], f), what=f)
    assert set(tmom[1]) == set(jmom[1])
    close_vec(tmom[1]["sum_dc"].numpy(), jmom[1]["sum_dc"])
    close_vec(tmom[1]["cis_add"].numpy(), jmom[1]["cis_add"])
    jw, jaux, js2 = jalg.apply_from_moments(key, jnp.asarray(w), jmom, js)
    tw, taux, ts2 = talg.apply_from_moments(noise, torch.tensor(w), tmom, ts)
    close_vec(tw.numpy(), jw)
    state_close(ts2, js2)
    assert float(taux.eta_g) == 1.0


@pytest.mark.parametrize("mode", list(MODES))
def test_the_gate_holds_masked_rows_and_padding_slots_out(mode):
    """With a nonzero c a masked row's dc would be -c: gated before the clip,
    it adds exactly nothing to the variate release or the table, and the
    gathered padding slots (client 0, mask 0) add exactly 0 to row 0."""
    rng = np.random.default_rng(6)
    talg = make_algorithm("dp-scaffold", **kwargs(mode, sigma_scale=0.0))
    _, ts = states(rng)
    assert ts.c.abs().min() > 0
    mask = np.array([1] * 8 + [0, 0], np.float32)
    x = raw_deltas(rng)[SLOTS]
    x[8:] = 0.0
    noise = talg.draw_noise(torch.Generator().manual_seed(0), M, D, "cpu")
    mom, extras = talg.local_moments(noise, torch.zeros(D), torch.tensor(x), torch.tensor(mask),
                                     torch.tensor(SLOTS), ts, binary_mask=True)
    on = SLOTS[:8]
    off = np.setdiff1d(np.arange(M), on)
    assert 0 in off and not extras["cis_add"][off].any()
    # the released dc sum is the sum of the participants' clipped rows alone
    dc = talg._dc(torch.tensor(x[:8]), ts.c_is[on], ts.c)
    want = torch.clamp(C * talg.variate_scale / dc.norm(dim=1, keepdim=True), max=1.0) * dc
    close_vec(extras["sum_dc"].numpy(), want.sum(0).numpy(), rtol=1e-6)
    close_vec(extras["cis_add"][on].numpy(), want.numpy(), rtol=1e-6)
    assert float(mom.count) == 8.0


@pytest.mark.parametrize("mode", list(MODES))
def test_a_multiplicity_is_its_draws_as_rows_of_their_own(mode):
    """A with-replacement mask releases each draw as a row of its own: the
    same sums as a binary block that repeats each drawn client's row (and
    its noise, keyed by client) as often as it was drawn; the table adds a
    duplicate's clipped dc twice."""
    rng = np.random.default_rng(8)
    talg = make_algorithm("dp-scaffold", **kwargs(mode))
    _, ts = states(rng)
    x = raw_deltas(rng)
    mask = np.zeros(M, np.float32)
    mask[[3, 7, 20]] = [2.0, 1.0, 3.0]
    x[mask == 0] = 0.0
    noise = talg.draw_noise(torch.Generator().manual_seed(1), M, D, "cpu")
    mom, extras = talg.local_moments(noise, torch.zeros(D), torch.tensor(x), torch.tensor(mask),
                                     0, ts, binary_mask=False)
    draws = np.array([3, 3, 7, 20, 20, 20])
    want, wextras = talg.local_moments(noise, torch.zeros(D), torch.tensor(x[draws]),
                                       torch.ones(len(draws)), torch.tensor(draws), ts,
                                       binary_mask=True)
    for f in ("sum_c", "sum_sq", "sum_sq_clipped"):
        assert torch.equal(torch.as_tensor(getattr(mom, f)), torch.as_tensor(getattr(want, f))), f
    assert float(mom.count) == 6.0
    assert torch.equal(extras["sum_dc"], wextras["sum_dc"])
    close_vec(extras["cis_add"].numpy(), wextras["cis_add"].numpy(), rtol=1e-6)
    assert not extras["cis_add"][mask == 0].any()


COHORTS = {"bernoulli": dict(q=0.3), "gathered": dict(q=0.3, gather=True),
           "fixed": dict(size=12), "replace": dict(size=12, replace=True)}


@pytest.mark.parametrize("cohort", list(COHORTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_round_matches_jax_round_step(mode, cohort, data):
    """One round through the round loop's hook (the trainer fed its block's
    variate rows) against JAX's ``_round_step`` on JAX's mask and noise."""
    jalg, talg = (jax_make("dp-scaffold", **kwargs(mode)),
                  make_algorithm("dp-scaffold", **kwargs(mode)))
    jcoh, tcoh = JaxCohort(**COHORTS[cohort]), CohortSpec(**COHORTS[cohort])
    rng = np.random.default_rng(7)
    js, ts = states(rng)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    t, key = 2, jax.random.PRNGKey(60)
    step = _round_step(jalg, jlocal.build_cohort_local_fn(jax_loss, JaxLocal(
        control_variates=True), TAU), None, 1, cohort=jcoh, tau=TAU)
    jw, js2, jouts = step(jnp.asarray(w), js, key, t, jbatches(data), ETA_L)
    mask = torch.tensor(np.asarray(jcoh.round_mask(key, M)))

    def local_fn(w_, b, eta, ctx):
        return cohort_updates_scaffold(linreg_loss, w_, b, TAU, eta, ctx)

    tw, aux, ts2 = sampled_round(talg, local_fn, torch.tensor(w), ts, noise_of(jalg, key), mask,
                                 tcoh, t, tbatches(data), ETA_L)
    close_vec(tw.numpy(), jw)
    state_close(ts2, js2)
    assert float(aux.eta_g) == float(jouts[0]) == 1.0


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedNoise(DPScaffoldServer):
    """dp-scaffold drawing round t's noise from a table (JAX's draws)."""

    noises: tuple = ()

    def draw_noise(self, gen, m, d, device, t=None):
        return self.noises[t]


def session(data, alg, cohort=None, device="cpu", **kw):
    return FederatedSession(alg, linreg_loss, np.zeros(D, np.float32),
                            {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(control_variates=True), cohort=cohort,
                            eval_fn=distance_to_opt(torch.tensor(data["w_star"])), device=device,
                            **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_sessions_match_jax_over_ten_rounds(mode, data):
    kw = kwargs(mode)
    jalg = jax_make("dp-scaffold", **kw)
    js = JaxSession(jalg, jax_loss, jnp.zeros(D), jbatches(data),
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                    local=JaxLocal(control_variates=True))
    key = jax.random.PRNGKey(5)
    want = js.run(key)
    noises = tuple(noise_of(jalg, jax.random.fold_in(key, t)) for t in range(ROUNDS))
    got = session(data, FedNoise(**kw, noises=noises)).run(0)
    close_vec(got.final_w.numpy(), want.final_w)
    close_vec(got.last_w.numpy(), want.last_w)
    assert torch.equal(got.eta_history, torch.ones(ROUNDS))
    dist = np.linalg.norm(np.asarray(want.final_w) - data["w_star"])
    close(float(torch.linalg.vector_norm(got.final_w - torch.tensor(data["w_star"]))), dist)


@pytest.mark.parametrize("mode", list(MODES))
def test_legacy_loop_equals_the_session_bit_for_bit(mode, data):
    kw = kwargs(mode)
    cfg = tscaffold.DPScaffoldConfig(clip_norm=C, sigma=kw["sigma"], central=kw["central"],
                                     num_clients=M)
    tscaffold._WARNED = False
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        runs = [tscaffold.run_dp_scaffold(cfg, linreg_loss, np.zeros(D, np.float32),
                                          {"x": data["x"], "y": data["y"]}, rounds=ROUNDS,
                                          tau=TAU, eta_l=ETA_L, seed=s,
                                          eval_fn=distance_to_opt(torch.tensor(data["w_star"])),
                                          device="cpu") for s in (3, 4)]
    assert sum(issubclass(w.category, DeprecationWarning) for w in seen) == 1
    sess = session(data, make_algorithm("dp-scaffold", **kw))
    for s, legacy in zip((3, 4), runs):
        r = sess.run(s)
        for f in ("final_w", "last_w", "eta_history", "metric_history"):
            assert torch.equal(getattr(r, f), getattr(legacy, f)), f
    assert not torch.equal(runs[0].final_w, runs[1].final_w)


@pytest.mark.parametrize("kind", ["bernoulli", "fixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_gathered_sessions_equal_dense_ones(mode, kind, data):
    spec = dict(q=0.3) if kind == "bernoulli" else dict(size=12)
    alg = make_algorithm("dp-scaffold", **kwargs(mode))
    dense = session(data, alg, CohortSpec(**spec)).run(3)
    gathered = session(data, alg, CohortSpec(**spec, gather=True)).run(3)
    close_vec(gathered.final_w.numpy(), dense.final_w.numpy())
    close_vec(gathered.metric_history.numpy(), dense.metric_history.numpy())
    assert torch.isfinite(dense.final_w).all()


@pytest.mark.parametrize("backend", ["kernel", "kernel-fused"])
def test_backends_give_the_plain_bits_on_the_cpu(backend, data):
    full = session(data, make_algorithm("dp-scaffold", **kwargs("ldp"), backend="torch")).run(2)
    r = session(data, make_algorithm("dp-scaffold", **kwargs("ldp"), backend=backend)).run(2)
    assert torch.equal(r.final_w, full.final_w)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_batched_equals_run_bit_for_bit(mode, data):
    sess = session(data, make_algorithm("dp-scaffold", **kwargs(mode)), CohortSpec(q=0.5))
    seeds = [0, 5, 9]
    rb = sess.run_batched(seeds)
    assert rb.final_w.shape == (3, D) and rb.eta_history.shape == (3, ROUNDS)
    for i, s in enumerate(seeds):
        r = sess.run(s)
        for f in ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
                  "eta_target_history"):
            torch.testing.assert_close(getattr(rb, f)[i], getattr(r, f), rtol=0, atol=0,
                                       equal_nan=True, msg=f)


def test_run_batched_with_seed_axes_on_w0_and_data(data):
    alg = make_algorithm("fedexp")
    w0s = np.stack([np.zeros(D, np.float32), 0.1 * np.ones(D, np.float32)])
    batches = {k: np.stack([data[k], data[k][::-1].copy()]) for k in ("x", "y")}
    sess = FederatedSession(alg, linreg_loss, w0s, batches,
                            train=TrainSpec(rounds=3, tau=TAU, eta_l=ETA_L),
                            cohort=CohortSpec(size=M // 2), num_clients=M, device="cpu")
    rb = sess.run_batched([0, 1], batched_w0=True, batched_data=True)
    assert rb.final_w.shape == (2, D)
    for i in range(2):
        one = FederatedSession(alg, linreg_loss, w0s[i], {k: v[i] for k, v in batches.items()},
                               train=TrainSpec(rounds=3, tau=TAU, eta_l=ETA_L),
                               cohort=CohortSpec(size=M // 2), device="cpu").run(i)
        assert torch.equal(rb.final_w[i], one.final_w)
    assert not torch.equal(rb.final_w[0], rb.final_w[1])


def test_run_refuses_a_stack_of_initial_models(data):
    sess = FederatedSession(make_algorithm("fedavg"), linreg_loss, np.zeros((2, D), np.float32),
                            {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=2, tau=1, eta_l=ETA_L), device="cpu")
    with pytest.raises(ValueError, match=r"run_batched\(seeds, batched_w0=True\)"):
        sess.run(0)
    assert sess.run_batched([0, 1], batched_w0=True).final_w.shape == (2, D)


def test_run_batched_refuses_what_jax_refuses(data):
    tree = FederatedSession(make_algorithm("fedavg"), lambda p, b: linreg_loss(p["w"], b),
                            {"w": np.zeros(D, np.float32)}, {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=2, tau=1, eta_l=ETA_L), device="cpu")
    with pytest.raises(ValueError, match="batched_w0 with a tree model"):
        tree.run_batched([0], batched_w0=True)
    tree_runs = tree.run_batched([0, 1])
    assert tree_runs.final_w["w"].shape == (2, D)
    flat = session(data, make_algorithm("dp-scaffold", **kwargs("ldp")))
    with pytest.raises(ValueError, match=r"batched_w0 needs a \(2, d\) stack"):
        flat.run_batched([0, 1], batched_w0=True)
    with pytest.raises(ValueError, match="batched_data needs a leading axis of 2 seeds"):
        flat.run_batched([0, 1], batched_data=True)


# ---------------------------------------------------------------------------
# Accounting and the session's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [dict(q=0.1), dict(size=7), dict(q=0.25, gather=True), {}])
@pytest.mark.parametrize("mode", list(MODES))
def test_privacy_report_equals_jax(mode, spec, data):
    kw = kwargs(mode)
    js = JaxSession(jax_make("dp-scaffold", **kw), jax_loss, jnp.zeros(D), jbatches(data),
                    train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                    local=JaxLocal(control_variates=True), cohort=JaxCohort(**spec))
    ts = session(data, make_algorithm("dp-scaffold", **kw), CohortSpec(**spec))
    want, got = js.privacy_report(1e-5), ts.privacy_report(1e-5)
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is b, f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f)
    budget = make_algorithm("dp-scaffold", **kw).budget(1e-5, rounds=ROUNDS, dim=D)
    jbudget = jax_make("dp-scaffold", **kw).budget(1e-5, rounds=ROUNDS, dim=D)
    np.testing.assert_allclose(budget.eps_numerical, jbudget.eps_numerical, rtol=1e-12)
    with pytest.raises(ValueError, match="sigma=0 is not private"):
        make_algorithm("dp-scaffold", **kwargs(mode, 0.0)).budget(1e-5, rounds=3)


def test_the_session_refuses_unpaired_trainers_and_tables(data):
    scaffold = make_algorithm("dp-scaffold", **kwargs("ldp"))
    batches = {"x": data["x"], "y": data["y"]}
    train = TrainSpec(rounds=2, tau=TAU, eta_l=ETA_L)
    with pytest.raises(ValueError, match="pass local=LocalSpec\\(control_variates=True\\)"):
        FederatedSession(scaffold, linreg_loss, np.zeros(D, np.float32), batches, train=train,
                         device="cpu")
    with pytest.raises(ValueError, match="needs a control-variate algorithm"):
        FederatedSession(make_algorithm("fedavg"), linreg_loss, np.zeros(D, np.float32), batches,
                         train=train, local=LocalSpec(control_variates=True), device="cpu")
    with pytest.raises(ValueError, match="carries a 39-client variate table for a 40-client"):
        FederatedSession(make_algorithm("dp-scaffold", **{**kwargs("ldp"), "num_clients": 39}),
                         linreg_loss, np.zeros(D, np.float32), batches, train=train,
                         local=LocalSpec(control_variates=True), device="cpu")
    # the spec trainers run: a session with each equals the same rounds taken
    # by hand through cohort_updates_spec, keyed by each round's seed
    samples = {"x": torch.tensor(data["x"])[:, None, :] * torch.linspace(0.5, 1.5, 8)[:, None]}
    samples["y"] = samples["x"] @ torch.tensor(data["w_star"])

    def mean_loss(w, b):
        return torch.mean(torch.square(b["x"] @ w - b["y"]))

    for spec in (LocalSpec(batch_size=4), LocalSpec(prox_mu=0.1), LocalSpec(momentum=0.5)):
        got = FederatedSession(make_algorithm("fedavg"), mean_loss, np.zeros(D, np.float32),
                               samples, train=train, local=spec, device="cpu").run(0)
        alg, w = make_algorithm("fedavg"), torch.zeros(D)
        state = alg.init_state(w)
        for t in range(train.rounds):
            gen = round_generator(0, t)
            deltas = cohort_updates_spec(mean_loss, w, samples, spec, TAU, ETA_L,
                                         gen.initial_seed())
            w, _, state = alg.apply_round_stateful(gen, w, deltas, state, t=t)
        assert torch.isfinite(got.last_w).all() and torch.equal(got.last_w, w), spec
    # the default spec is full-batch GD, bit for bit
    plain = FederatedSession(make_algorithm("fedexp"), linreg_loss, np.zeros(D, np.float32),
                             batches, train=train, device="cpu").run(0)
    spec = FederatedSession(make_algorithm("fedexp"), linreg_loss, np.zeros(D, np.float32),
                            batches, train=train, local=LocalSpec(), device="cpu").run(0)
    assert torch.equal(plain.final_w, spec.final_w)
