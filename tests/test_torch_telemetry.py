"""The port's telemetry tap against the JAX package's, on the CPU (the
counterpart of ``tests/test_telemetry.py``).

A tracked run equals an untracked one in bits on all three engines; the
event streams equal JAX's for the same data (at sigma = 0: eta, eta_naive,
eta_target and metric at rtol 1e-5; clip, sigma, participants and
bytes_per_round exactly; the ledger fields at 1e-12); the last ledger entry
is ``privacy_report``; the fault totals are the sums of the round's own
masks; resume and rollback streams, profile events, ``run_batched``'s
per-seed replay, ``TelemetrySpec`` validation case for case and
``spec_identity`` against JAX's string; ``tools/check_telemetry.py``
accepts every stream written here.  Sizes: M = 32, d = 12, 6 rounds.
"""
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import distance_to_opt as jax_dist  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim import EngineSpec as JaxEngine  # noqa: E402
from repro.fedsim import FaultSpec as JaxFault  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim.specs import TelemetrySpec as JaxTelemetry  # noqa: E402
from repro.telemetry import JsonlTracker as JaxJsonl  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    EngineSpec,
    FaultSpec,
    FederatedSession,
    RecoveryPolicy,
    StreamSpec,
    TelemetrySpec,
    TrainSpec,
)
from repro_torch.fedsim.faults import fault_masks  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    CompositeTracker,
    JsonlTracker,
    NullTracker,
    Tracker,
)

_spec = importlib.util.spec_from_file_location(
    "check_telemetry", Path(__file__).resolve().parents[1] / "tools" / "check_telemetry.py")
check_telemetry = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_telemetry)

M, D, TAU, ETA_L, ROUNDS = 32, 12, 3, 0.1, 6
DELTA = 1e-5
FAULT = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.05)
FIELDS = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")
KWARGS = {"fedexp": {}, "fedavg": {},
          "cdp-fedexp": dict(clip_norm=0.3, sigma=0.2, num_clients=M),
          "dp-fedavg-cdp": dict(clip_norm=0.3, sigma=0.2, num_clients=M),
          "ldp-fedexp-gauss": dict(clip_norm=0.3, sigma=0.2),
          "cdp-fedexp-schedule": dict(clip_norm=0.3, sigma=0.2, num_clients=M, decay=0.9),
          "cdp-fedexp-adaptive-clip": dict(z_mult=1.0, num_clients=M, c0=0.3)}
ENGINES = {"eager": dict(engine=EngineSpec("eager")),
           "scan": dict(engine=EngineSpec("scan", chunk_rounds=4)),
           "stream": dict(engine=EngineSpec("stream"), stream=StreamSpec(12))}


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(3), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def port(data, name="cdp-fedexp", engine="scan", rounds=ROUNDS, kw=None, **specs):
    specs = {**ENGINES[engine], **specs}
    return FederatedSession(
        make_algorithm(name, **(KWARGS[name] if kw is None else kw)), linreg_loss,
        torch.zeros(D), {"x": torch.tensor(data["x"]), "y": torch.tensor(data["y"])},
        train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
        eval_fn=distance_to_opt(torch.tensor(data["w_star"])), device="cpu", **specs)


def jax_session(data, name, kw=None, **specs):
    return JaxSession(jax_make(name, **(KWARGS[name] if kw is None else kw)), jax_loss,
                      jnp.zeros(D), {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                      train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                      eval_fn=jax_dist(jnp.asarray(data["w_star"])), **specs)


def lines(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def rounds_of(path):
    return [o for o in lines(path) if "event" not in o]


def valid(path, **kw):
    """``tools/check_telemetry.py`` accepts the stream."""
    errors = check_telemetry.check_stream(Path(path).read_text().splitlines(), label=str(path),
                                          **kw)
    assert errors == [], errors


def same_bits(a, b):
    assert a.fault_round == b.fault_round
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), f


class ListTracker(Tracker):
    def __init__(self):
        self.events, self.phases, self.finished = [], [], 0

    def log(self, step, event):
        self.events.append((step, dict(event)))

    def start_phase(self, name, step=0):
        self.phases.append((name, step))

    def finish(self):
        self.finished += 1


# ---------------------------------------------------------------------------
# the tap observes, it never perturbs
# ---------------------------------------------------------------------------

CASES = {"eager": {}, "scan": {}, "stream": {},
         "scan sampled": dict(cohort=CohortSpec(q=0.5)),
         "eager faults": dict(fault=FaultSpec(**FAULT)),
         "scan gathered faults": dict(cohort=CohortSpec(q=0.5, gather=True),
                                      fault=FaultSpec(**FAULT))}


@pytest.mark.parametrize("case", list(CASES))
def test_a_tracked_run_equals_an_untracked_one(case, data, tmp_path):
    engine = case.split()[0]
    s = port(data, engine=engine, **CASES[case])
    path = tmp_path / "t.jsonl"
    tracked = s.run(5, tracker=JsonlTracker(str(path)))
    same_bits(tracked, s.run(5))
    same_bits(s.run(5, tracker=NullTracker()), tracked)
    valid(path, rounds=ROUNDS, require_bytes=True)
    got = rounds_of(path)
    assert [o["round"] for o in got] == list(range(ROUNDS))
    np.testing.assert_array_equal([o["eta"] for o in got], tracked.eta_history.numpy())


# ---------------------------------------------------------------------------
# the streams against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss", "fedexp",
                                  "cdp-fedexp-adaptive-clip"])
def test_the_stream_equals_jaxs_at_sigma_zero(name, data, tmp_path):
    kw = dict(KWARGS[name])
    if "sigma" in kw:
        kw["sigma"] = 0.0
    if "z_mult" in kw:
        kw.update(z_mult=0.0, sigma_b=0.0)
    jp, tp = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    # sigma = 0 has no budget (the JAX package's probe does not catch its
    # ZeroDivisionError): the ledger is off on both sides
    jax_session(data, name, kw, telemetry=JaxTelemetry(ledger_delta=None)).run(
        jax.random.PRNGKey(0), tracker=JaxJsonl(str(jp)))
    port(data, name, kw=kw, telemetry=TelemetrySpec(ledger_delta=None)).run(
        0, tracker=JsonlTracker(str(tp)))
    want, got = rounds_of(jp), rounds_of(tp)
    valid(tp, rounds=ROUNDS)
    assert len(got) == len(want) == ROUNDS
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in ("eta", "eta_naive", "eta_target", "metric"):
            if w.get(k) is None:
                assert g.get(k) is None, k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        # the adaptive clip is a carried float32 value, held as eta is
        exact = ("sigma", "participants", "bytes_per_round", "round") + (
            () if "adaptive" in name else ("clip",))
        for k in exact:
            assert g.get(k) == w.get(k), k
        if "adaptive" in name:
            np.testing.assert_allclose(g["clip"], w["clip"], rtol=1e-5)


@pytest.mark.parametrize("name,cohort", [("cdp-fedexp-schedule", 0.5), ("ldp-fedexp-gauss", None)])
def test_the_ledger_equals_jaxs(name, cohort, data, tmp_path):
    jp, tp = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jspec = {} if cohort is None else dict(cohort=JaxCohort(q=cohort))
    tspec = {} if cohort is None else dict(cohort=CohortSpec(q=cohort))
    jax_session(data, name, **jspec).run(jax.random.PRNGKey(0), tracker=JaxJsonl(str(jp)))
    s = port(data, name, **tspec)
    s.run(0, tracker=JsonlTracker(str(tp)))
    want, got = rounds_of(jp), rounds_of(tp)
    for g, w in zip(got, want):
        assert g["ledger_rounds"] == w["ledger_rounds"]
        for k in ("mu", "eps", "eps_rdp"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)
        for k in ("clip", "sigma", "bytes_per_round"):
            assert g.get(k) == w.get(k), k
    rep = s.privacy_report(DELTA)
    assert got[-1]["eps"] == rep.eps_numerical and got[-1]["mu"] == rep.mu
    valid(tp, rounds=ROUNDS, sigma0=0.2 if "schedule" in name else None, sigma_decay=0.9)


def test_no_ledger_without_a_budget_or_a_delta(data, tmp_path):
    p = tmp_path / "a.jsonl"
    port(data, "fedavg").run(0, tracker=JsonlTracker(str(p)))
    assert all("eps" not in o and "ledger_error" not in o for o in rounds_of(p))
    q = tmp_path / "b.jsonl"
    port(data, telemetry=TelemetrySpec(ledger_delta=None)).run(0, tracker=JsonlTracker(str(q)))
    assert all("eps" not in o for o in rounds_of(q))
    valid(p, rounds=ROUNDS)
    valid(q, rounds=ROUNDS)


@pytest.mark.parametrize("engine", ["eager", "scan", "stream"])
def test_fault_totals_are_the_sums_of_the_rounds_own_masks(engine, data, tmp_path):
    fault, seed = FaultSpec(**FAULT), 7
    p = tmp_path / "f.jsonl"
    port(data, engine=engine, fault=fault, cohort=CohortSpec(q=0.6)).run(
        seed, tracker=JsonlTracker(str(p)))
    for o in rounds_of(p):
        gen = round_generator(seed, o["round"])
        mask = CohortSpec(q=0.6).round_mask(gen, M).double()
        alive, strag, corr = (v.double() for v in fault_masks(fault, gen.initial_seed(), M))
        assert o["participants"] == int(mask.sum())
        assert o["realized_clients"] == int((mask * alive * (1 - corr)).sum())
        assert o["dropped"] == int((mask * (1 - alive)).sum())
        assert o["stragglers"] == int((mask * alive * strag).sum())
        assert o["corrupt"] == int((mask * alive * corr).sum())
    valid(p, rounds=ROUNDS)


# ---------------------------------------------------------------------------
# resume, rollback, profile windows, per-seed replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_resume_emits_only_the_new_rounds(engine, data, tmp_path):
    ck = str(tmp_path / "ck")
    port(data, engine=engine, rounds=3).run(2, checkpoint_dir=ck)
    p = tmp_path / "resume.jsonl"
    s = port(data, engine=engine)
    t = ListTracker()
    s.resume(ck, tracker=CompositeTracker(t, JsonlTracker(str(p))))
    assert t.phases == [("resume", 3)] and t.finished == 1
    got = rounds_of(p)
    assert [o["round"] for o in got] == [3, 4, 5]
    assert [o["ledger_rounds"] for o in got] == [4, 5, 6]
    assert abs(got[-1]["eps"] - s.privacy_report(DELTA).eps_numerical) < 1e-12
    valid(p)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_a_rollback_is_an_event_and_the_retried_round_charges_the_ledger(engine, data,
                                                                         tmp_path):
    specs = dict(fault=FaultSpec(watchdog=True))
    s = port(data, engine=engine, **specs)

    def poison_first_attempt(carry, attempt):
        if attempt >= 1:
            return carry
        w = carry[0].clone()
        w[0] = float("nan")
        return (w,) + tuple(carry[1:])

    s._inject_divergence = poison_first_attempt
    p = tmp_path / "rb.jsonl"
    r = s.run(4, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
              on_divergence=RecoveryPolicy(max_retries=2), tracker=JsonlTracker(str(p)))
    assert r.fault_round is None
    rollbacks = [o for o in lines(p) if o.get("event") == "rollback"]
    assert [(o["round"], o["to_round"], o["attempt"]) for o in rollbacks] == [(0, 0, 1)]
    # the scan engine's payload carries the trip (the JAX scan engine's); the
    # eager engine reports the tripping round as it ran, as JAX's eager does
    assert any(o.get("watchdog_fault_round") == 0 for o in lines(p)) == (engine == "scan")
    valid(p, rounds=ROUNDS)
    last = rounds_of(p)[-1]
    assert last["ledger_rounds"] == ROUNDS + 1
    assert abs(last["eps"] - s.privacy_report(DELTA).eps_numerical) < 1e-12
    ref = port(data, engine=engine, **specs).run(4)
    assert torch.equal(ref.final_w, r.final_w)


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_a_profile_window_is_traced_and_logged(engine, data, tmp_path):
    prof = str(tmp_path / "trace")
    p = tmp_path / "prof.jsonl"
    port(data, engine=engine, telemetry=TelemetrySpec(profile_rounds=(2, 4), profile_dir=prof)
         ).run(0, tracker=JsonlTracker(str(p)))
    assert [(o["event"], o["round"]) for o in lines(p) if "event" in o] == [
        ("profile_start", 2), ("profile_stop", 4)]
    assert os.listdir(prof)
    assert [o["round"] for o in rounds_of(p)] == list(range(ROUNDS))
    valid(p, rounds=ROUNDS)


def test_run_batched_replays_each_seeds_events(data, tmp_path):
    p = tmp_path / "b.jsonl"
    s = port(data, engine="scan")
    r = s.run_batched([0, 1, 2], tracker=JsonlTracker(str(p)))
    got = lines(p)
    for seed in range(3):
        mine = [o for o in got if o.get("seed") == seed]
        assert [o["round"] for o in mine] == list(range(ROUNDS))
        np.testing.assert_array_equal([o["eta"] for o in mine], r.eta_history[seed].numpy())
        assert [o["ledger_rounds"] for o in mine] == list(range(1, ROUNDS + 1))
        for o, m in zip(mine, r.metric_history[seed].tolist()):
            assert ("metric" in o) == math.isfinite(m)
    lines_by_seed = [json.dumps({k: v for k, v in o.items() if k != "seed"}) for o in got
                     if o.get("seed") == 1]
    assert check_telemetry.check_stream(lines_by_seed, rounds=ROUNDS) == []


# ---------------------------------------------------------------------------
# TelemetrySpec and spec_identity against JAX
# ---------------------------------------------------------------------------

TELEMETRY_CASES = [dict(), dict(ledger_delta=None), dict(ledger_delta=0.0),
                   dict(ledger_delta=1.0), dict(ledger_delta=1e-3),
                   dict(profile_rounds=(0, 1)), dict(profile_rounds=(2, 2)),
                   dict(profile_rounds=(-1, 3)), dict(profile_dir="x/y")]


@pytest.mark.parametrize("kw", TELEMETRY_CASES, ids=str)
def test_telemetry_spec_accepts_and_refuses_what_jax_does(kw):
    try:
        want = JaxTelemetry(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            TelemetrySpec(**kw)
        assert str(err.value) == str(e)
        return
    assert repr(TelemetrySpec(**kw)) == repr(want)


IDENTITY_CASES = {
    "eager": (dict(engine=EngineSpec("eager")), dict(engine=JaxEngine("eager"))),
    "scan chunked": (dict(engine=EngineSpec("scan", chunk_rounds=3)),
                     dict(engine=JaxEngine("scan", chunk_rounds=3))),
    "sampled faults telemetry": (
        dict(engine=EngineSpec("scan"), cohort=CohortSpec(q=0.5, gather=True),
             fault=FaultSpec(dropout=0.1, watchdog=True), telemetry=TelemetrySpec(
                 ledger_delta=1e-6, profile_rounds=(1, 2))),
        dict(engine=JaxEngine("scan"), cohort=JaxCohort(q=0.5, gather=True),
             fault=JaxFault(dropout=0.1, watchdog=True), telemetry=JaxTelemetry(
                 ledger_delta=1e-6, profile_rounds=(1, 2)))),
}


@pytest.mark.parametrize("case", list(IDENTITY_CASES))
def test_spec_identity_is_jaxs_string(case, data):
    tspec, jspec = IDENTITY_CASES[case]
    got = FederatedSession(
        make_algorithm("cdp-fedexp", **KWARGS["cdp-fedexp"]), linreg_loss, torch.zeros(D),
        {"x": torch.tensor(data["x"]), "y": torch.tensor(data["y"])},
        train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L), device="cpu", **tspec)
    want = jax_session(data, "cdp-fedexp", **jspec)
    assert got.spec_identity() == want.spec_identity()
