"""The port's ten monolithic algorithm classes (``repro_torch.core.fedexp``)
against the JAX package's same classes and against the port's own registry
names, on the CPU.

* Each class against the JAX class on JAX's own draws (``round_noise_of``
  of the JAX composition, whose draws the JAX class makes bit for bit): the
  dense round, and both moment halves with 3 masked rows, at rtol 1e-5.
* Each class against ``make_algorithm(name)`` of the port in bits: 4-round
  sessions (dense and a gathered q = 0.5 cohort under the scan engine, and
  the stream engine) and both moment halves with their extras, on the
  port's own draws.
* ``privacy_report`` against the JAX session's (which dispatches on the
  name) at 1e-12, and the port session's name dispatch for an algorithm
  without ``budget``.
* The stateful classes' ``TypeError`` guards, and the telemetry's clip slot
  of the adaptive class against the C it carries.

M = 24 clients, d = 12, tau = 2 and 4 rounds, as tests/test_compose.py.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fedexp as jfx  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.fedsim import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro_torch.core import fedexp as tfx  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    EngineSpec,
    FederatedSession,
    StreamSpec,
    TrainSpec,
    mask_rows,
)
from repro_torch.fedsim.server import tap_payload  # noqa: E402
from repro_torch.fedsim.session import _budget_by_name  # noqa: E402
from repro_torch.telemetry.trackers import Tracker  # noqa: E402

from test_torch_moments import close, close_vec, deltas_for, round_noise_of  # noqa: E402

M, D, TAU, ETA_L, ROUNDS = 24, 12, 2, 0.1, 4
PRIVUNIT = dict(eps0=2.0, eps1=2.0, eps2=2.0, dim=D)
CDP = dict(clip_norm=1.0, sigma=5.0 / math.sqrt(M), num_clients=M)
KW = {
    "fedavg": {},
    "fedexp": {},
    "dp-fedavg-ldp-gauss": dict(clip_norm=1.0, sigma=0.7),
    "ldp-fedexp-gauss": dict(clip_norm=1.0, sigma=0.7),
    "dp-fedavg-privunit": dict(clip_norm=1.0, **PRIVUNIT),
    "ldp-fedexp-privunit": dict(clip_norm=1.0, **PRIVUNIT),
    "dp-fedavg-cdp": CDP,
    "cdp-fedexp": CDP,
    "dp-fedadam-cdp": dict(CDP, server_lr=0.05),
    "cdp-fedexp-adaptive-clip": dict(z_mult=1.2, num_clients=M, dim=D, c0=1.0, sigma_b=4.0),
}
CLASSES = {  # name -> (the port's class, the JAX package's class)
    "fedavg": (tfx.FedAvg, jfx.FedAvg),
    "fedexp": (tfx.FedEXP, jfx.FedEXP),
    "dp-fedavg-ldp-gauss": (tfx.DPFedAvgLDPGaussian, jfx.DPFedAvgLDPGaussian),
    "ldp-fedexp-gauss": (tfx.LDPFedEXPGaussian, jfx.LDPFedEXPGaussian),
    "dp-fedavg-privunit": (tfx.DPFedAvgPrivUnit, jfx.DPFedAvgPrivUnit),
    "ldp-fedexp-privunit": (tfx.LDPFedEXPPrivUnit, jfx.LDPFedEXPPrivUnit),
    "dp-fedavg-cdp": (tfx.DPFedAvgCDP, jfx.DPFedAvgCDP),
    "cdp-fedexp": (tfx.CDPFedEXP, jfx.CDPFedEXP),
    "dp-fedadam-cdp": (tfx.DPFedAdamCDP, jfx.DPFedAdamCDP),
    "cdp-fedexp-adaptive-clip": (tfx.CDPFedEXPAdaptiveClip, jfx.CDPFedEXPAdaptiveClip),
}
NAMES = sorted(CLASSES)
PRIVATE = [n for n in NAMES if n not in ("fedavg", "fedexp")]
AUX = ("eta_g", "eta_naive", "eta_target", "update_norm")
RESULT_FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
                 "eta_target_history")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread (a pool of them only contends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_class(name):
    return CLASSES[name][0](**KW[name])


def jax_class(name):
    return CLASSES[name][1](**KW[name])


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_linreg(torch.Generator().manual_seed(3), M, D)


def round_inputs(seed=0):
    """Rows whose norms keep clear of C = 1 and of the adaptive clip's C, a
    model, and a mask with its last 3 rows out (their rows zeroed)."""
    rng = np.random.default_rng(seed)
    x = deltas_for(rng, M, D)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    mask = np.concatenate([np.ones(M - 3), np.zeros(3)]).astype(np.float32)
    return x, w, mask


def aux_close(taux, jaux, what):
    for f in AUX:
        j, g = float(getattr(jaux, f)), float(getattr(taux, f))
        assert math.isnan(j) == math.isnan(g), f"{what}: {f}"
        if not math.isnan(j):
            close(g, j, what=f"{what}: {f}")


def test_every_class_is_exported():
    import repro_torch.core as core
    for name, (cls, jcls) in CLASSES.items():
        assert cls.__name__ in tfx.__all__ and getattr(core, cls.__name__) is cls
        assert cls.__name__ == jcls.__name__
        alg = port_class(name)
        assert alg.name == name == jax_class(name).name
        assert alg.is_private == jax_class(name).is_private == make_algorithm(
            name, **KW[name]).is_private


# ---------------------------------------------------------------------------
# against the JAX package's classes, on JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_dense_round_matches_the_jax_class(name):
    talg, jalg = port_class(name), jax_class(name)
    x, w, _ = round_inputs(1)
    key = jax.random.PRNGKey(5)
    noise = round_noise_of(jax_make(name, **KW[name]), key, M, D)
    jstate = jalg.init_state(jnp.asarray(w))
    tstate = talg.init_state(torch.tensor(w))
    jw, jaux, jstate = jalg.apply_round_stateful(key, jnp.asarray(w), jnp.asarray(x), jstate)
    tw, taux, tstate = talg.apply_round_stateful(None, torch.tensor(w), torch.tensor(x), tstate,
                                                 noise)
    close_vec(tw.numpy(), jw)
    aux_close(taux, jaux, name)
    if name == "cdp-fedexp-adaptive-clip":
        close(tstate.clip, jstate.clip, what="clip")
    if name == "dp-fedadam-cdp":
        for got, want in zip(tstate, jstate):
            close_vec(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_moment_halves_match_the_jax_class(name):
    talg, jalg = port_class(name), jax_class(name)
    x, w, mask = round_inputs(2)
    x[mask == 0] = 0.0                  # the round zeroes left-out rows at the source
    key = jax.random.PRNGKey(6)
    noise = round_noise_of(jax_make(name, **KW[name]), key, M, D)
    jstate = jalg.init_state(jnp.asarray(w))
    tstate = talg.init_state(torch.tensor(w))
    jmom = jalg.local_moments(key, jnp.asarray(w), jnp.asarray(x), jnp.asarray(mask), 0, jstate)
    tmom = talg.local_moments(noise, torch.tensor(w), torch.tensor(x), torch.tensor(mask), 0,
                              tstate)
    assert isinstance(tmom, tuple) == isinstance(jmom, tuple)
    (tbase, tex), (jbase, jex) = ((m if isinstance(m, tuple) else (m, {}))
                                  for m in (tmom, jmom))
    close_vec(tbase.sum_c.numpy(), jbase.sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tbase, f), getattr(jbase, f), what=f"{name}: {f}")
    assert set(tex) == set(jex)
    for k in jex:
        close(tex[k], jex[k], what=f"{name}: {k}")
    jw, jaux, jstate = jalg.apply_from_moments(key, jnp.asarray(w), jmom, jstate)
    tw, taux, tstate = talg.apply_from_moments(noise, torch.tensor(w), tmom, tstate)
    close_vec(tw.numpy(), jw)
    aux_close(taux, jaux, name)
    if name == "cdp-fedexp-adaptive-clip":
        close(tstate.clip, jstate.clip, what="clip")


# ---------------------------------------------------------------------------
# against the port's registry names, in bits
# ---------------------------------------------------------------------------

def same_bits(a, b, what):
    """Equal in bits, NaN included (a float is compared as its bit pattern)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)
    assert torch.equal(a, b), what


def run(problem, alg, tracker=None, **specs):
    session = FederatedSession(alg, linreg_loss, torch.zeros(D), problem.client_batches(),
                               train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                               eval_fn=distance_to_opt(problem.w_star), device="cpu", **specs)
    return session.run(11, tracker=tracker)


KINDS = {  # the session's specs: the default scan engine dense and gathered, and
    # the stream engine in chunks of 10 (the last one padded past M)
    "dense": {},
    "gathered": dict(cohort=CohortSpec(q=0.5, gather=True)),
    "stream": dict(engine=EngineSpec("stream"), stream=StreamSpec(chunk_clients=10)),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", NAMES)
def test_session_equals_the_registry_name_in_bits(problem, name, kind):
    mono = run(problem, port_class(name), **KINDS[kind])
    comp = run(problem, make_algorithm(name, **KW[name]), **KINDS[kind])
    for f in RESULT_FIELDS:
        same_bits(getattr(mono, f), getattr(comp, f), f"{name}.{f}")
    assert torch.isfinite(mono.final_w).all()


@pytest.mark.parametrize("name", NAMES)
def test_moment_halves_equal_the_registry_name_in_bits(name):
    mono, comp = port_class(name), make_algorithm(name, **KW[name])
    x, w, mask = round_inputs(3)
    x, w, mask = mask_rows(torch.tensor(x), torch.tensor(mask)), torch.tensor(w), torch.tensor(mask)
    gen_m, gen_c = round_generator(7, 2), round_generator(7, 2)
    noise_m = mono.stage_noise(mono.draw_noise(gen_m, M, D, "cpu", 2), "cpu", 2)
    noise_c = comp.stage_noise(comp.draw_noise(gen_c, M, D, "cpu", 2), "cpu", 2)
    for f in dataclasses.fields(noise_m):   # the same fields, drawn in the same order
        a, b = getattr(noise_m, f.name), getattr(noise_c, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            same_bits(a, b, f"noise.{f.name}")
    s_m, s_c = mono.init_state(w), comp.init_state(w)
    mom_m = mono.local_moments(noise_m, w, x, mask, 0, s_m)
    mom_c = comp.local_moments(noise_c, w, x, mask, 0, s_c)
    base_m, ex_m = mom_m if isinstance(mom_m, tuple) else (mom_m, {})
    for f in ("sum_c", "sum_sq", "sum_sq_clipped", "count"):
        same_bits(getattr(base_m, f), getattr(mom_c[0], f), f"{name}.{f}")
    for k, v in ex_m.items():           # the class's extras, as the registry's
        same_bits(v, mom_c[1][k], f"{name}.extras[{k}]")
    w_m, aux_m, s_m = mono.apply_from_moments(noise_m, w, mom_m, s_m)
    w_c, aux_c, s_c = comp.apply_from_moments(noise_c, w, mom_c, s_c)
    same_bits(w_m, w_c, f"{name}: w")
    same_bits(aux_m.eta_g, aux_c.eta_g, f"{name}: eta_g")
    same_bits(aux_m.eta_target, aux_c.eta_target, f"{name}: eta_target")
    if name == "cdp-fedexp-adaptive-clip":
        same_bits(s_m.clip, s_c.clip, "clip")


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def jax_report(name, q):
    from repro.data.synthetic import make_synthetic_linreg as jax_data
    data = jax_data(jax.random.PRNGKey(3), M, D)
    session = JaxSession(jax_class(name), jax_loss, jnp.zeros(D), data.client_batches(),
                         train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                         cohort=JaxCohort() if q == 1.0 else JaxCohort(q=q))
    return session.privacy_report(delta=1e-5)


def reports_close(got, want):
    assert got.setting == want.setting
    for f in ("eps_numerical", "eps_rdp", "delta", "mu"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=0,
                                   err_msg=f)


@pytest.mark.parametrize("q", [1.0, 0.5])
@pytest.mark.parametrize("name", PRIVATE)
def test_privacy_report_matches_jax(problem, name, q):
    session = FederatedSession(port_class(name), linreg_loss, torch.zeros(D),
                               problem.client_batches(),
                               train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                               cohort=None if q == 1.0 else CohortSpec(q=q), device="cpu")
    want = jax_report(name, q)
    reports_close(session.privacy_report(delta=1e-5), want)
    # the session's name dispatch, for an algorithm that has no budget
    reports_close(_budget_by_name(port_class(name), 1e-5, ROUNDS, D, q), want)


def test_a_noiseless_class_has_no_report(problem):
    for name in ("fedavg", "fedexp"):
        session = FederatedSession(port_class(name), linreg_loss, torch.zeros(D),
                                   problem.client_batches(),
                                   train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                                   device="cpu")
        with pytest.raises(ValueError, match="not a private algorithm"):
            session.privacy_report(delta=1e-5)


# ---------------------------------------------------------------------------
# guards and telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dp-fedadam-cdp", "cdp-fedexp-adaptive-clip"])
def test_stateful_classes_refuse_a_stateless_round(name):
    alg = port_class(name)
    for jalg, call in ((jax_class(name), lambda a: a.apply_round(jax.random.PRNGKey(0),
                                                                  jnp.zeros(D),
                                                                  jnp.zeros((M, D)))),
                       (alg, lambda a: a.apply_round(round_generator(0, 0), torch.zeros(D),
                                                     torch.zeros(M, D)))):
        with pytest.raises(TypeError, match="apply_round_stateful"):
            call(jalg)


class Events(Tracker):
    def __init__(self):
        self.events = []

    def log(self, step, event):
        self.events.append((step, event))


def test_telemetry_clip_slot_is_the_carried_clip(problem):
    name = "cdp-fedexp-adaptive-clip"
    alg = port_class(name)
    state = alg.init_state(torch.zeros(D))
    state = dataclasses.replace(state, clip=torch.tensor(0.8125))
    out = tuple(torch.tensor(v) for v in (1.5, 0.25, float("nan"), float("nan")))
    payload = tap_payload(alg, state, out, torch.zeros(6), -1)
    same_bits(payload[4], state.clip, "clip slot")
    # a carry that is a tensor (a momentum buffer) has a ``clip`` method, not a C
    cdp = make_algorithm("cdp-fedmom", **CDP)
    payload = tap_payload(cdp, torch.zeros(D), out, torch.zeros(6), -1)
    same_bits(payload[4], torch.tensor(CDP["clip_norm"]), "static clip slot")
    mono, comp = Events(), Events()
    run(problem, alg, tracker=mono)
    run(problem, make_algorithm(name, **KW[name]), tracker=comp)
    clips = [e["clip"] for _, e in mono.events if "clip" in e]
    assert len(clips) == ROUNDS and clips[0] == KW[name]["c0"]
    assert len(set(clips)) > 1          # C moves from round to round
    assert clips == [e["clip"] for _, e in comp.events if "clip" in e]
