"""Client sharding (``ShardSpec`` over ``torch.distributed``) on the CPU.

One rank (a one-process gloo group, ``make_client_mesh()``): the sharded
session equals the unsharded one in bits, for every registry name under the
scan engine, and sampled, gathered, faulted and compressed, under the scan
and stream engines.  One all-reduce a round.

Two ranks: a gloo group of two child processes (``test_torch_shard_worker.py``),
spawned once for the module, runs every case; the parent holds rank 0's
results to the JAX package's single-device sessions on the same
numpy-seeded data and the same draws (the noise, cohort masks and faults
replayed), weights and metrics at rtol 1e-5 and the eta histories at rtol
1e-4 (the JAX package's own bars for its sharded engine), and rank 1's to
rank 0's in bits.  Cases: dense names of every mechanism, padding (M = 45
over two ranks; a stream grid of 16-client chunks), Bernoulli, gathered,
faulted and compressed rounds, the stream and gather-stream engines.  With
the port's own draws the two-rank runs equal the unsharded runs at rtol
1e-5: each rank's LDP noise is its clients' rows of the cohort's noise,
keyed by global row.

Also: only shard 0's tap reports; the refusals with the JAX package's
messages, ``auto_shard_count`` and ``client_shard_spec`` against JAX's,
``spec_identity``'s shard part,
``pad_cohort`` / ``chunk_cohort(n_shards=)`` against JAX's, the rank
layout, ``masked_cohort_updates`` and the logical-axis rules.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim import EngineSpec as JaxEngine  # noqa: E402
from repro.fedsim import FaultSpec as JaxFault  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import ShardSpec as JaxShard  # noqa: E402
from repro.fedsim import StreamSpec as JaxStream  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import faults as jfaults  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.specs import DataSpec as JaxData  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.core import compose as tcomp  # noqa: E402
from repro_torch.core.algorithm import all_reduce_moments, round_generator  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    DataSpec,
    EngineSpec,
    FaultSpec,
    FederatedSession,
    HostArraySource,
    LocalSpec,
    ShardSpec,
    StreamSpec,
    TrainSpec,
    chunk_cohort,
    masked_cohort_updates,
    pad_cohort,
)
from repro_torch.fedsim import server as srv  # noqa: E402
from repro_torch.fedsim.local import cohort_updates  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.telemetry.tap import TapSession  # noqa: E402
from repro_torch.telemetry.trackers import Tracker  # noqa: E402
from test_torch_moments import algo_kwargs, round_noise_of  # noqa: E402

M, D, TAU, ETA_L, ROUNDS, SEED = 44, 24, 2, 0.1, 3, 11
RESULT = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")
FAULT_KW = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.1)
STREAM = dict(engine=EngineSpec(engine="stream"), stream=StreamSpec(16))


def arrays(m):
    d = jax_data(jax.random.PRNGKey(3), m, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y")}


@pytest.fixture(scope="module")
def data():
    return arrays(M)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank client mesh over a one-process gloo group, torn down after."""
    made = not dist.is_initialized()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    m = tmesh.make_client_mesh()
    yield m
    if made:
        dist.destroy_process_group()


def kwargs(name, m=M):
    if name == "dp-scaffold":
        return dict(clip_norm=1.0, sigma=0.7, central=False, num_clients=m, tau=TAU, eta_l=ETA_L)
    return algo_kwargs(name, m, D)


def session(data, name, *, alg=None, rounds=ROUNDS, **kw):
    return FederatedSession(alg or make_algorithm(name, **kwargs(name)), linreg_loss,
                            np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                            else None, device="cpu", **kw)


def same(a, b):
    """Equal in bits, NaN where both are NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def same_run(a, b):
    return all(same(getattr(a, f), getattr(b, f)) for f in RESULT)


def sketch(**kw):
    return tcomp.CountSketchAggregation(width=6, depth=3, **kw)


# ---------------------------------------------------------------------------
# one rank: the unsharded run in bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list_algorithms())
def test_one_rank_is_the_unsharded_scan_run_in_bits(name, data, mesh):
    before = all_reduce_moments.launches
    got = session(data, name, shard=ShardSpec(mesh)).run(SEED)
    assert all_reduce_moments.launches - before == ROUNDS     # one all-reduce a round
    assert same_run(got, session(data, name).run(SEED))


KINDS = {
    "bernoulli": dict(cohort=CohortSpec(q=0.5)),
    "gathered": dict(cohort=CohortSpec(q=0.5, gather=True)),
    "replace": dict(cohort=CohortSpec(size=12, replace=True)),
    "faulted": dict(fault=FaultSpec(**FAULT_KW)),
    "stream": STREAM,
    "stream-gathered": dict(STREAM, cohort=CohortSpec(q=0.5, gather=True)),
    "stream-faulted": dict(STREAM, fault=FaultSpec(**FAULT_KW)),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss", "ldp-fedexp-privunit",
                                  "dp-scaffold"])
def test_one_rank_is_the_unsharded_run_in_bits(name, kind, data, mesh):
    before = all_reduce_moments.launches
    got = session(data, name, shard=ShardSpec(mesh), **KINDS[kind]).run(SEED)
    assert all_reduce_moments.launches - before == ROUNDS
    assert same_run(got, session(data, name, **KINDS[kind]).run(SEED))


@pytest.mark.parametrize("kind", ["dense", "gathered", "stream"])
@pytest.mark.parametrize("agg", ["randk", "sketch-ef"])
def test_one_rank_compressed_is_the_unsharded_run_in_bits(agg, kind, data, mesh):
    layer = tcomp.RandKAggregation(k=8) if agg == "randk" else sketch(top_k=12,
                                                                       error_feedback=True)
    alg = tcomp.with_compression(make_algorithm("cdp-fedexp", **kwargs("cdp-fedexp")), layer)
    kw = {"dense": {}, "gathered": KINDS["gathered"], "stream": STREAM}[kind]
    assert same_run(session(data, "cdp-fedexp", alg=alg, shard=ShardSpec(mesh), **kw).run(SEED),
                    session(data, "cdp-fedexp", alg=alg, **kw).run(SEED))


@pytest.mark.parametrize("name", ["cdp-fedexp", "ldp-fedexp-gauss", "ldp-fedexp-privunit",
                                  "ldp-fedexp-perclient"])
def test_apply_round_sharded_at_one_rank_is_the_dense_round_in_bits(name, mesh):
    """The method of the JAX package's ``apply_round_sharded``: at one rank,
    with no padding row, the dense round's release sum for sum."""
    alg = make_algorithm(name, **kwargs(name))
    rng = np.random.default_rng(11)
    w = torch.tensor(0.1 * rng.standard_normal(D), dtype=torch.float32)
    deltas = torch.tensor(rng.standard_normal((M, D)), dtype=torch.float32)
    gen = round_generator(SEED, 2)
    noise = alg.stage_noise(alg.draw_noise(gen, M, D, "cpu", 2), "cpu", 2)
    state = alg.init_state(w)
    before = all_reduce_moments.launches
    got = alg.apply_round_sharded(noise, w, deltas, None, 0, state, dist.group.WORLD,
                                  m_total=M, t=2)
    assert all_reduce_moments.launches - before == 1
    want = alg.apply_round_stateful(None, w, deltas, state, noise=noise, t=2)
    assert torch.equal(got[0], want[0])
    for f in ("eta_g", "eta_naive", "eta_target"):
        assert same(getattr(got[1], f), getattr(want[1], f)), f


def test_one_rank_run_batched_resume_and_checkpoints_are_unsharded_bits(data, mesh, tmp_path):
    sharded = session(data, "ldp-fedexp-gauss", rounds=4, shard=ShardSpec(mesh))
    plain = session(data, "ldp-fedexp-gauss", rounds=4)
    batched = sharded.run_batched([SEED, SEED + 1])
    want = plain.run_batched([SEED, SEED + 1])
    assert all(same(getattr(batched, f), getattr(want, f)) for f in RESULT)
    session(data, "ldp-fedexp-gauss", rounds=2, shard=ShardSpec(mesh)).run(
        SEED, checkpoint_dir=str(tmp_path))
    assert same_run(sharded.resume(str(tmp_path)), plain.run(SEED))


# ---------------------------------------------------------------------------
# two ranks: the JAX package's single-device session
# ---------------------------------------------------------------------------

def jax_session(dat, name, agg, rounds, specs):
    alg = jax_make(name, **kwargs(name, dat["x"].shape[0]))
    if agg is not None:
        import repro.core.compose as jcomp
        cls, kw = agg
        alg = jcomp.with_compression(alg, getattr(jcomp, cls)(**kw))
    return alg, JaxSession(alg, jax_loss, jnp.zeros(D),
                           {k: jnp.asarray(v) for k, v in dat.items()},
                           train=JaxTrain(rounds=rounds, tau=TAU, eta_l=ETA_L), **specs)


# id: (registry name, M, compression layer, the port's specs, JAX's specs)
TWO_RANK = {
    "cdp-fedexp": ("cdp-fedexp", M, None, {}, {}),
    "ldp-fedexp-gauss": ("ldp-fedexp-gauss", M, None, {}, {}),
    "ldp-fedexp-privunit": ("ldp-fedexp-privunit", M, None, {}, {}),
    "cdp-fedexp-adaptive-clip": ("cdp-fedexp-adaptive-clip", M, None, {}, {}),
    "fedexp-padded": ("fedexp", 45, None, {}, {}),
    "cdp-fedexp-bernoulli": ("cdp-fedexp", 45, None,
                             {"cohort": ("CohortSpec", dict(q=0.5))},
                             {"cohort": JaxCohort(q=0.5)}),
    "ldp-fedexp-gauss-gathered": ("ldp-fedexp-gauss", M, None,
                                  {"cohort": ("CohortSpec", dict(q=0.5, gather=True))},
                                  {"cohort": JaxCohort(q=0.5, gather=True)}),
    "cdp-fedexp-faulted": ("cdp-fedexp", M, None, {"fault": ("FaultSpec", FAULT_KW)},
                           {"fault": JaxFault(**FAULT_KW)}),
    "cdp-fedexp-sketch-ef": ("cdp-fedexp", M, ("CountSketchAggregation",
                                               dict(width=6, depth=3, top_k=12,
                                                    error_feedback=True)), {}, {}),
    "ldp-fedexp-gauss-stream": ("ldp-fedexp-gauss", M, None,
                                {"engine": ("EngineSpec", dict(engine="stream")),
                                 "stream": ("StreamSpec", dict(chunk_clients=16))},
                                {"engine": JaxEngine(engine="stream"),
                                 "stream": JaxStream(chunk_clients=16)}),
    "cdp-fedexp-gather-stream": ("cdp-fedexp", M, None,
                                 {"engine": ("EngineSpec", dict(engine="stream")),
                                  "stream": ("StreamSpec", dict(chunk_clients=8)),
                                  "cohort": ("CohortSpec", dict(q=0.5, gather=True))},
                                 {"engine": JaxEngine(engine="stream"),
                                  "stream": JaxStream(chunk_clients=8),
                                  "cohort": JaxCohort(q=0.5, gather=True)}),
    "fedavg-randk-stream": ("fedavg", M, ("RandKAggregation", dict(k=8)),
                            {"engine": ("EngineSpec", dict(engine="stream")),
                             "stream": ("StreamSpec", dict(chunk_clients=16))},
                            {"engine": JaxEngine(engine="stream"),
                             "stream": JaxStream(chunk_clients=16)}),
}
# the port's own draws: two ranks against the unsharded port
OWN = {
    "own-ldp-fedexp-gauss": ("ldp-fedexp-gauss", 45, {}),
    "own-ldp-fedexp-privunit-stream": ("ldp-fedexp-privunit", M,
                                       {"engine": ("EngineSpec", dict(engine="stream")),
                                        "stream": ("StreamSpec", dict(chunk_clients=16))}),
    "own-ldp-fedexp-perclient-gathered": ("ldp-fedexp-perclient", 45,
                                          {"cohort": ("CohortSpec", dict(q=0.5, gather=True))}),
    "own-dp-scaffold-faulted": ("dp-scaffold", 45, {"fault": ("FaultSpec", FAULT_KW)}),
}
# a recovering run on both ranks: a shared checkpoint directory, a divergence
# planted in the first attempt, against the unsharded port's unkilled run
RECOVER = {
    "recover-scan": ("ldp-fedexp-gauss", 45, {"fault": ("FaultSpec", dict(watchdog=True))}),
    "recover-stream": ("cdp-fedexp", M, {"fault": ("FaultSpec", dict(watchdog=True)),
                                         "engine": ("EngineSpec", dict(engine="stream")),
                                         "stream": ("StreamSpec", dict(chunk_clients=16))}),
}


def _case(name, dat, agg, specs, *, noises=None, masks=None, faults=None, unsharded=False):
    return dict(name=name, kw=kwargs(name, dat["x"].shape[0]), agg=agg, data=dat,
                rounds=ROUNDS, tau=TAU, eta_l=ETA_L, seed=SEED, specs=specs, noises=noises,
                masks=masks, faults=faults, unsharded=unsharded)


def _replayed(cid, dat):
    """The case of ``cid`` with the JAX session's draws of each round."""
    name, m, agg, tspecs, jspecs = TWO_RANK[cid]
    jalg, _ = jax_session(dat, name, agg, ROUNDS, jspecs)
    key = jax.random.PRNGKey(SEED)
    keys = [jax.random.fold_in(key, t) for t in range(ROUNDS)]
    noises = {t: round_noise_of(jalg, keys[t], m, D, t, raw=True) for t in range(ROUNDS)}
    masks = faults = None
    if "cohort" in jspecs:
        masks = [np.asarray(jspecs["cohort"].round_mask(k, m)) for k in keys]
    if "fault" in jspecs:
        faults = {round_generator(SEED, t).initial_seed():
                  tuple(None if v is None else np.asarray(v)
                        for v in jfaults.fault_masks(jspecs["fault"], keys[t], m))
                  for t in range(ROUNDS)}
    return _case(name, dat, agg, tspecs, noises=noises, masks=masks, faults=faults)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank case run once by a gloo group of two child processes:
    ``{case id: (rank 0's results, rank 1's)}``."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    data_of = {m: arrays(m) for m in (M, 45)}
    cases = {cid: _replayed(cid, data_of[TWO_RANK[cid][1]]) for cid in TWO_RANK}
    for cid, (name, m, specs) in OWN.items():
        cases[cid] = _case(name, data_of[m], None, specs, unsharded=True)
    for cid, (name, m, specs) in RECOVER.items():
        cases[cid] = dict(_case(name, data_of[m], None, specs, unsharded=True),
                          recover=dict(dir=str(tmp / cid), every=2))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"), str(here),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(here / "test_torch_shard_worker.py"),
                               str(tmp / "cases.pkl"), str(r), "2", str(tmp / "store"),
                               str(tmp / f"out{r}.pkl")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return {cid: (out[0][cid], out[1][cid]) for cid in cases}


def _held(got, want, what):
    for f in ("final_w", "last_w", "metric_history"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what}.{f}")
    for f in ("eta_history", "eta_naive_history", "eta_target_history"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}.{f}")


@pytest.mark.parametrize("cid", list(TWO_RANK))
def test_two_ranks_match_the_jax_single_device_session(cid, two_ranks):
    name, m, agg, _, jspecs = TWO_RANK[cid]
    rank0, rank1 = two_ranks[cid]
    assert rank0["all_reduces"] == ROUNDS == rank1["all_reduces"]
    assert all(same(rank0["sharded"][f], rank1["sharded"][f]) for f in RESULT)
    _, js = jax_session(arrays(m), name, agg, ROUNDS, jspecs)
    _held(rank0["sharded"], js.run(jax.random.PRNGKey(SEED)), cid)


@pytest.mark.parametrize("cid", list(OWN))
def test_two_ranks_on_the_ports_draws_match_the_unsharded_run(cid, two_ranks):
    rank0, rank1 = two_ranks[cid]
    assert rank0["all_reduces"] == ROUNDS
    assert all(same(rank0["sharded"][f], rank1["sharded"][f]) for f in RESULT)
    for f in RESULT:
        want = rank0["unsharded"][f]
        np.testing.assert_allclose(rank0["sharded"][f], want,
                                   rtol=1e-4 if f.startswith("eta") else 1e-5, atol=1e-5,
                                   err_msg=f"{cid}.{f}")


@pytest.mark.parametrize("cid", list(RECOVER))
def test_two_ranks_roll_back_to_their_shared_checkpoints(cid, two_ranks):
    """Both ranks find no checkpoint, rank 0 writes the rollback target, the
    planted divergence rolls both back to it, and the recovered run is the
    unkilled unsharded run (no rank hangs on a collective the other skips)."""
    rank0, rank1 = two_ranks[cid]
    assert all(same(rank0["sharded"][f], rank1["sharded"][f]) for f in RESULT)
    for r in (rank0, rank1):
        assert r["sharded"]["fault_round"] is None and r["sharded"]["retried"] == 1
        assert r["sharded"]["latest"] == ROUNDS
    for f in RESULT:
        np.testing.assert_allclose(rank0["sharded"][f], rank0["unsharded"][f],
                                   rtol=1e-4 if f.startswith("eta") else 1e-5, atol=1e-5,
                                   err_msg=f"{cid}.{f}")


class _Events(Tracker):
    def __init__(self):
        self.events = []

    def log(self, step, event):
        self.events.append((step, {k: v for k, v in event.items() if k != "round_time_s"}))


def test_only_shard_0_reports(data, mesh):
    """A tracked one-rank sharded run logs the unsharded run's events; a tap
    on any other shard logs nothing, rollbacks and profile windows neither."""
    got, want = _Events(), _Events()
    session(data, "cdp-fedexp", shard=ShardSpec(mesh)).run(SEED, tracker=got)
    session(data, "cdp-fedexp").run(SEED, tracker=want)
    assert repr(got.events) == repr(want.events) and len(got.events) == ROUNDS   # NaN alike
    other = _Events()
    tap = TapSession(other, shard=1)
    tap.emit(0, np.zeros(12, np.float32))
    tap.rollback(0, 0, 1)
    tap.profile_event("start", 0, "trace")
    assert other.events == [] and tap.expected_t == 0


# ---------------------------------------------------------------------------
# refusals, the mesh helpers, the layout
# ---------------------------------------------------------------------------

def _messages(port_call, jax_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_a_mesh_under_eager_is_refused_as_jax(data, mesh):
    s = session(data, "fedavg", engine=EngineSpec(engine="eager"), shard=ShardSpec(mesh))
    js = JaxSession(jax_make("fedavg"), jax_loss, jnp.zeros(D),
                    {k: jnp.asarray(v) for k, v in data.items()},
                    train=JaxTrain(rounds=2, tau=TAU, eta_l=ETA_L),
                    engine=JaxEngine(engine="eager"), shard=JaxShard(jmesh.make_client_mesh()))
    _messages(lambda: s.run(0), lambda: js.run(jax.random.PRNGKey(0)))
    for call in (lambda: s.resume("nowhere"), lambda: s.run_batched([0])):
        with pytest.raises(ValueError, match="requires engine='scan'"):
            call()


def test_a_host_source_with_a_mesh_is_refused_as_jax(data, mesh):
    src = HostArraySource({"x": data["x"], "y": data["y"]})

    def port():
        FederatedSession(make_algorithm("fedavg"), linreg_loss, np.zeros(D, np.float32), src,
                         train=TrainSpec(rounds=2, tau=TAU, eta_l=ETA_L),
                         engine=EngineSpec(engine="stream"), data=DataSpec(kind="host"),
                         shard=ShardSpec(mesh), device="cpu")

    def jax_():
        from repro.fedsim.data import HostArraySource as JaxHost
        JaxSession(jax_make("fedavg"), jax_loss, jnp.zeros(D),
                   JaxHost({"x": data["x"], "y": data["y"]}),
                   train=JaxTrain(rounds=2, tau=TAU, eta_l=ETA_L),
                   engine=JaxEngine(engine="stream"), data=JaxData(kind="host"),
                   shard=JaxShard(jmesh.make_client_mesh()))

    _messages(port, jax_)


def test_a_mesh_must_be_one_dimension_named_the_client_axis(data, mesh):
    with pytest.raises(ValueError, match="named 'cohort'"):
        session(data, "fedavg", shard=ShardSpec(mesh, client_axis="cohort"))
    with pytest.raises(ValueError, match="process group of 1"):
        tmesh.make_client_mesh(2)
    assert tmesh.make_client_mesh().size(0) == 1


@pytest.mark.parametrize("m,n_dev", [(96, 8), (300, 8), (10, 8), (48, 2), (24, 1), (0, 4)])
def test_auto_shard_count_equals_jax(m, n_dev):
    assert tmesh.auto_shard_count(m, n_devices=n_dev) == jmesh.auto_shard_count(m,
                                                                                n_devices=n_dev)
    assert tmesh.auto_shard_count(m, n_devices=n_dev, min_clients_per_shard=10) == \
        jmesh.auto_shard_count(m, n_devices=n_dev, min_clients_per_shard=10)
    assert tmesh.MIN_CLIENTS_PER_SHARD == jmesh.MIN_CLIENTS_PER_SHARD


def test_client_shard_spec_equals_jax(mesh):
    got = tmesh.client_shard_spec("auto", num_clients=10_000)
    want = jmesh.client_shard_spec("auto", num_clients=10_000)
    assert got.n_shards == want.mesh.shape["clients"] == 1
    assert got.client_axis == want.client_axis
    _messages(lambda: tmesh.client_shard_spec("auto"), lambda: jmesh.client_shard_spec("auto"))


def test_spec_identity_names_the_mesh_as_jax(data, mesh):
    s = session(data, "fedavg", shard=ShardSpec(mesh))
    js = JaxSession(jax_make("fedavg"), jax_loss, jnp.zeros(D),
                    {k: jnp.asarray(v) for k, v in data.items()},
                    train=JaxTrain(rounds=2, tau=TAU, eta_l=ETA_L),
                    shard=JaxShard(jmesh.make_client_mesh()))
    assert s.spec_identity().split(" | ")[-1] == js.spec_identity().split(" | ")[-1] \
        == "shard=mesh[clients=1] axis=clients"


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_pad_and_chunk_cohort_over_shards_equal_jax(data, n):
    tb = {k: torch.tensor(v) for k, v in data.items()}
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tpad, tmask = pad_cohort(tb, n)
    jpad, jmask = jlocal.pad_cohort(jb, n)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for k in tb:
        np.testing.assert_array_equal(tpad[k].numpy(), np.asarray(jpad[k]))
    tgrid, tcm = chunk_cohort(tb, 8, n_shards=n)
    jgrid, jcm = jlocal.chunk_cohort(jb, 8, n_shards=n)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    for k in tb:
        np.testing.assert_array_equal(tgrid[k].numpy(), np.asarray(jgrid[k]))


@pytest.mark.parametrize("n,multiple", [(2, 1), (3, 1), (2, 16), (3, 8)])
def test_each_rank_holds_its_rows_of_the_padded_cohort(data, n, multiple):
    tb = {k: torch.tensor(v) for k, v in data.items()}
    padded, mask = (chunk_cohort(tb, multiple, n_shards=n) if multiple > 1
                    else pad_cohort(tb, n))
    padded = {k: v.reshape((-1,) + tuple(tb[k].shape[1:])) for k, v in padded.items()}
    mask = mask.reshape(-1)
    rows = []
    for r in range(n):
        lay = srv.shard_layout(M, n, r, multiple=multiple)
        local = srv.local_cohort(tb, lay, "cpu")
        assert lay.m_local * n == mask.shape[0]
        assert torch.equal(lay.pad_mask(), mask[lay.start:lay.start + lay.m_local])
        rows.append(local)
        full = torch.arange(M, dtype=torch.float32)
        assert torch.equal(lay.rows(full), torch.cat([full, torch.zeros(mask.shape[0] - M)])[
            lay.start:lay.start + lay.m_local])
    for k in tb:
        assert torch.equal(torch.cat([r[k] for r in rows]), padded[k])


def test_masked_cohort_updates_zero_the_masked_rows_as_jax(data):
    w = np.full(D, 0.05, np.float32)
    mask = np.array([1.0, 0.0] * (M // 2), np.float32)
    batches = {k: v.copy() for k, v in data.items()}
    batches["x"][1] = np.nan        # a masked client's NaN update reaches nothing
    got = masked_cohort_updates(linreg_loss, torch.tensor(w),
                                {k: torch.tensor(v) for k, v in batches.items()}, TAU, ETA_L,
                                torch.tensor(mask))
    want = jlocal.masked_cohort_updates(jax_loss, jnp.asarray(w),
                                        {k: jnp.asarray(v) for k, v in batches.items()}, TAU,
                                        ETA_L, jnp.asarray(mask))
    assert torch.isfinite(got).all() and not got[1::2].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert torch.equal(got[0::2], cohort_updates(linreg_loss, torch.tensor(w), {
        k: torch.tensor(v[0::2]) for k, v in batches.items()}, TAU, ETA_L))


def test_the_logical_axis_rules_place_the_client_axis():
    fake = type("Mesh", (), dict(mesh_dim_names=("clients",), shape=(4,)))()
    rules = sharding.client_axis_rules(fake)
    assert rules == {"clients": "clients", sharding.AXIS_SIZES_KEY: {"clients": 4}}
    assert sharding.logical_to_pspec(("clients", None, None), rules) == ("clients", None, None)
    assert sharding.logical_to_pspec(("clients", None), rules, dims=(6, 3)) == (None, None)
    assert sharding.logical_to_pspec(("clients", "clients"), rules) == ("clients", None)
    assert sharding.current_rules() is None and sharding.group_count("clients") == 1
    x = torch.zeros(8, 3)
    with sharding.axis_rules(rules):
        assert sharding.current_rules() is rules and sharding.group_count("clients") == 4
        assert sharding.shard(x, "clients", None) is x
        with pytest.raises(ValueError):
            sharding.shard(x, "clients")
    assert sharding.shard(x, "anything") is x
