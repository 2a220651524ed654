"""The port's streaming engine on the CPU: against the JAX package, and the
streamed round against the port's eager rounds.

Against JAX: ``streamed_clip_moments`` (the ``jnp`` backend against the
plain version, the same materialized noise, weights and mask) at rtol 1e-5;
``pad_cohort``/``chunk_cohort`` grids and masks and ``auto_chunk_clients``
exactly; the noiseless names' streamed sessions against JAX's stream
sessions at rtol 1e-5 (a vector's atol 1e-5 times its largest entry).
Inside the port: streamed = eager for all 17 registry names at rtol 1e-5;
one chunk = the masked-moment round in bits; sampled, fixed-size and
gathered cohorts with chunks that are entirely empty, the minibatch trainer,
a tree model and faults against the eager engine at rtol 1e-5;
kill/resume, ``run_batched`` and the round's draws in bits; the session's
refusals; the chunked kernel wrapper's plain path.  M = 44 is not a
multiple of the 16-client chunk, so every streamed run has a padded tail.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import EngineSpec as JaxEngine  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import StreamSpec as JaxStream  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.specs import DataSpec as JaxData  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import list_algorithms, make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    DataSpec,
    EngineSpec,
    FaultSpec,
    FederatedSession,
    HostArraySource,
    LocalSpec,
    RecoveryPolicy,
    StreamSpec,
    TrainSpec,
    chunk_cohort,
    pad_cohort,
)
from repro_torch.fedsim import server as srv  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops, ref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_moments import algo_kwargs, close_vec  # noqa: E402

M, D, TAU, ETA_L, ROUNDS, CHUNK = 44, 24, 2, 0.1, 4, 16
SEED = 11
STREAM = dict(engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk_clients=CHUNK))
FAULT = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.1)
RESULT = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(3), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y", "w_star")}


def kwargs(name):
    """make_algorithm kwargs at M clients; dp-scaffold in its LDP mode."""
    if name == "dp-scaffold":
        return dict(clip_norm=1.0, sigma=0.7, central=False, num_clients=M, tau=TAU,
                    eta_l=ETA_L)
    return algo_kwargs(name, m=M, d=D)


def session(arrays, name, *, rounds=ROUNDS, alg=None, batches=None, **kw):
    batches = {"x": arrays["x"], "y": arrays["y"]} if batches is None else batches
    return FederatedSession(alg or make_algorithm(name, **kwargs(name)), linreg_loss,
                            np.zeros(D, np.float32), batches,
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L),
                            local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                            else None,
                            eval_fn=distance_to_opt(torch.tensor(arrays["w_star"])),
                            device="cpu", **kw)


def runs_close(got, want, rtol=1e-5):
    for f in ("final_w", "last_w", "eta_history", "metric_history"):
        close_vec(getattr(got, f), getattr(want, f), rtol)


def same(a, b):
    """Equal in bits, NaN where both are NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def same_run(a, b):
    return all(same(getattr(a, f), getattr(b, f)) for f in RESULT)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((M, D)).astype(np.float32) * 0.2
    u[3] *= 20.0   # a row that clips hard
    noise = (0.2 * rng.standard_normal((M, D))).astype(np.float32)
    mask = (rng.random(M) < 0.6).astype(np.float32)
    weights = np.arange(1.0, M + 1.0, dtype=np.float32)
    return u, noise, mask, weights


@pytest.mark.parametrize("chunk", [7, 16, M, 100])
@pytest.mark.parametrize("noised,weighted,masked", [(True, False, True), (False, True, True),
                                                    (True, True, True), (True, False, False)],
                         ids=["noise-mask", "weights-mask", "all", "noise-only"])
def test_streamed_clip_moments_match_jax(rows, chunk, noised, weighted, masked):
    u, noise, mask, weights = rows
    kw = dict(chunk_clients=chunk)
    j = jagg.streamed_clip_moments(
        jnp.asarray(u), 0.3, jnp.asarray(noise) if noised else None, backend="jnp",
        weight_mask=jnp.asarray(mask) if masked else None,
        row_weights=jnp.asarray(weights) if weighted else None, **kw)
    t = tagg.streamed_clip_moments(
        torch.tensor(u), 0.3, torch.tensor(noise) if noised else None, backend="torch",
        weight_mask=torch.tensor(mask) if masked else None,
        row_weights=torch.tensor(weights) if weighted else None, **kw)
    close_vec(t.sum_c, np.asarray(j.sum_c))
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        np.testing.assert_allclose(float(getattr(t, f)), float(getattr(j, f)), rtol=1e-5)


@pytest.mark.parametrize("chunk", [7, 16, M, 100])
def test_streamed_clip_moments_equal_one_call(rows, chunk):
    """Chunked = partial_clip_moments up to re-association; one chunk in bits;
    a seeded noise keyed by global row draws the dense draw's rows."""
    u, _, mask, _ = rows
    u, mask = torch.tensor(u), torch.tensor(mask)
    kw = dict(noise_seed=5, noise_sigma=0.2, weight_mask=mask)
    dense = tagg.partial_clip_moments(u, 0.3, **kw)
    got = tagg.streamed_clip_moments(u, 0.3, chunk_clients=chunk, **kw)
    for f in ("sum_c", "sum_sq", "sum_sq_clipped", "count"):
        a, b = torch.as_tensor(getattr(got, f)), torch.as_tensor(getattr(dense, f))
        if chunk >= M:
            assert torch.equal(a, b)
        else:
            close_vec(a, b)
    assert float(tagg.streamed_clip_moments(u, 0.3, chunk_clients=11).count) == M
    with pytest.raises(ValueError, match="chunk_clients must be >= 1"):
        tagg.streamed_clip_moments(u, 0.3, chunk_clients=0)


@pytest.mark.parametrize("chunk", [1, 7, 16, M, 100])
def test_chunk_grid_equals_jax(data, chunk):
    batches = {"x": data["x"], "y": data["y"]}
    jgrid, jmask = jlocal.chunk_cohort({k: jnp.asarray(v) for k, v in batches.items()}, chunk)
    tgrid, tmask = chunk_cohort({k: torch.tensor(v) for k, v in batches.items()}, chunk)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for k in batches:
        np.testing.assert_array_equal(tgrid[k].numpy(), np.asarray(jgrid[k]))
    jpad, jpm = jlocal.pad_cohort({k: jnp.asarray(v) for k, v in batches.items()}, chunk)
    tpad, tpm = pad_cohort({k: torch.tensor(v) for k, v in batches.items()}, chunk)
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    for k in batches:
        np.testing.assert_array_equal(tpad[k].numpy(), np.asarray(jpad[k]))
    with pytest.raises(ValueError, match="chunk_clients must be >= 1"):
        chunk_cohort(batches, 0)


@pytest.mark.parametrize("rows_n,chunk", [(M, 1), (M, 16), (M, M), (M, 100), (48, 16)])
def test_chunk_grid_pads_with_row_zero_at_mask_zero(rows_n, chunk):
    """The one grid: chunk j is rows [j c, (j + 1) c), a row past the end
    reads row 0 and is not valid; its valid rows are JAX's pad_cohort mask."""
    grid = list(ref.chunk_grid(rows_n, chunk))
    assert [j0 for j0, _, _ in grid] == list(range(0, rows_n, chunk))
    idx, valid = (torch.cat([g[i] for g in grid]) for i in (1, 2))
    g = torch.arange(idx.shape[0])
    assert torch.equal(idx, torch.where(g < rows_n, g, 0))
    _, jmask = jlocal.pad_cohort({"x": jnp.zeros((rows_n, 1))}, chunk)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jmask))
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        list(ref.chunk_grid(rows_n, 0))


@pytest.mark.parametrize("dim,client_bytes,budget", [
    (24, 0, 1 << 20), (24, 100, 1 << 20), (131072, 0, 20 << 30), (32, 128, 20 << 30),
    (5, 3, 86), (1, 0, 8), (237, 3136, 123456789)])
def test_auto_chunk_clients_equals_jax(dim, client_bytes, budget):
    assert tmesh.auto_chunk_clients(dim, client_bytes, budget_bytes=budget) == \
        jmesh.auto_chunk_clients(dim, client_bytes, budget_bytes=budget)


def test_auto_chunk_clients_refuses_as_jax():
    with pytest.raises(ValueError) as jerr:
        jmesh.auto_chunk_clients(100, 10, budget_bytes=100)
    with pytest.raises(ValueError) as terr:
        tmesh.auto_chunk_clients(100, 10, budget_bytes=100)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="dim must be >= 1"):
        tmesh.auto_chunk_clients(0)
    # the CPU budget is the JAX package's documented fallback: a quarter of 4 GiB
    assert tmesh.device_memory_budget("cpu") == (4 << 30) // 4
    assert tmesh.auto_chunk_clients(24, device="cpu") == ((4 << 30) // 4) // (8 * 24)


@pytest.mark.parametrize("name", ["fedavg", "fedexp"])
@pytest.mark.parametrize("chunk", [CHUNK, M])
def test_noiseless_stream_sessions_equal_jax(data, name, chunk):
    jbatches = {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])}
    want = JaxSession(jax_make(name), jax_loss, jnp.zeros(D), jbatches,
                      train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                      engine=JaxEngine(engine="stream"),
                      stream=JaxStream(chunk_clients=chunk)).run(jax.random.PRNGKey(SEED))
    got = session(data, name, engine=EngineSpec(engine="stream"),
                  stream=StreamSpec(chunk_clients=chunk)).run(SEED)
    for f in ("final_w", "last_w", "eta_history"):
        close_vec(getattr(got, f), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("kw", [dict(chunk_clients=0), dict(chunk_clients="half")])
def test_stream_spec_refuses_as_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxStream(**kw)
    with pytest.raises(ValueError) as terr:
        StreamSpec(**kw)
    assert str(terr.value) == str(jerr.value)
    assert StreamSpec("auto").is_auto and not StreamSpec(8).is_auto


@pytest.mark.parametrize("kw", [dict(kind="gpu"), dict(prefetch=0)])
def test_data_spec_refuses_as_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxData(**kw)
    with pytest.raises(ValueError) as terr:
        DataSpec(**kw)
    assert str(terr.value) == str(jerr.value)


def test_engine_spec_accepts_stream_only_beside_eager():
    assert EngineSpec(engine="stream").engine == "stream"
    with pytest.raises(ValueError, match="unknown engine"):
        EngineSpec(engine="streaming")
    # the scan engine is the third (tests/test_torch_scan.py)
    assert EngineSpec(engine="scan").engine == "scan"


# ---------------------------------------------------------------------------
# inside the port: the streamed round against the eager rounds
# ---------------------------------------------------------------------------

NAMES = list_algorithms()


def test_every_registry_name_streams():
    assert len(NAMES) == 17 and "dp-scaffold" in NAMES


@pytest.mark.parametrize("name", NAMES)
def test_stream_equals_eager(data, name):
    want = session(data, name).run(SEED)
    got = session(data, name, **STREAM).run(SEED)
    runs_close(got, want)


def _one_chunk_round(data, name, cohort, t=1):
    """One streamed round with one chunk, and the masked-moment round fed
    the same draws: ``(stream, eager)`` outputs of round t."""
    s = session(data, name, engine=EngineSpec(engine="stream"), stream=StreamSpec(M),
                cohort=cohort)
    alg, w, batches = s.algorithm, torch.linspace(-0.3, 0.4, D), s.client_batches
    state = alg.init_state(w)
    got = s._step()(w, state, round_generator(SEED, t), t, batches, ETA_L)
    gen = round_generator(SEED, t)
    if cohort is None:
        mask, cohort = torch.ones(M), CohortSpec(size=M)   # the static count of full participation
    else:
        mask = cohort.round_mask(gen, M)
    noise = alg.stage_noise(alg.draw_noise(gen, M, D, w.device, t), w.device, t)
    inp = srv.stage_inputs(alg, s._local_fn, noise, t, M, w.device, cohort=cohort, mask=mask,
                           seed=gen.initial_seed())
    w_next, aux, state_next = srv.masked_round(alg, s._local_fn, w, state, inp, cohort, t,
                                               batches, ETA_L)
    return got, (w_next, state_next, aux)


def _state_leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _state_leaves(s)]
    if hasattr(state, "__dataclass_fields__"):
        return [x for f in state.__dataclass_fields__ for x in _state_leaves(getattr(state, f))]
    return []


@pytest.mark.parametrize("name", NAMES)
def test_one_chunk_is_the_masked_moment_round_in_bits(data, name):
    (w_s, state_s, outs), (w_e, state_e, aux) = _one_chunk_round(data, name, None)
    assert torch.equal(w_s, w_e)
    assert same(outs[0], aux.eta_g)
    for a, b in zip(_state_leaves(state_s), _state_leaves(state_e)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cohort", [CohortSpec(q=0.3), CohortSpec(size=9),
                                    CohortSpec(q=0.3, gather=True)], ids=str)
def test_one_chunk_sampled_session_equals_eager_in_bits(data, cohort):
    want = session(data, "ldp-fedexp-gauss", cohort=cohort).run(SEED)
    got = session(data, "ldp-fedexp-gauss", cohort=cohort, engine=EngineSpec(engine="stream"),
                  stream=StreamSpec(64)).run(SEED)
    assert same_run(got, want)


def _empty_chunk_rounds(cohort, chunk):
    """Rounds of ROUNDS whose plan holds a chunk with no client on."""
    out = []
    for t in range(ROUNDS):
        mask = cohort.round_mask(round_generator(SEED, t), M)
        plan = srv.chunk_plan(mask, cohort, chunk)
        if any(float(mj.sum()) == 0.0 for _, mj, _ in plan):
            out.append(t)
    return out


@pytest.mark.parametrize("cohort,chunk", [
    (CohortSpec(q=0.1), 8), (CohortSpec(size=5), CHUNK), (CohortSpec(size=5, replace=True), 8),
    (CohortSpec(q=0.3, gather=True), 4), (CohortSpec(q=0.1, gather=True, gather_cap=20), 4)],
    ids=str)
@pytest.mark.parametrize("name", ["ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit",
                                  "dp-scaffold"])
def test_sampled_stream_equals_eager_with_empty_chunks(data, cohort, chunk, name):
    assert _empty_chunk_rounds(cohort, chunk), "no round of the test has an empty chunk"
    want = session(data, name, cohort=cohort).run(SEED)
    got = session(data, name, cohort=cohort, engine=EngineSpec(engine="stream"),
                  stream=StreamSpec(chunk)).run(SEED)
    runs_close(got, want)
    assert torch.isfinite(got.final_w).all()


def test_an_empty_round_is_a_zero_update(data):
    got = session(data, "cdp-fedexp", cohort=CohortSpec(q=0.01), rounds=8, **STREAM).run(SEED)
    assert torch.isfinite(got.final_w).all() and torch.isfinite(got.eta_history).all()


@pytest.mark.parametrize("cohort", [None, CohortSpec(q=0.4, gather=True)], ids=str)
def test_minibatch_trainer_streams(cohort):
    rng = np.random.default_rng(7)
    samples = rng.standard_normal((M, 16, D)).astype(np.float32)

    def sample_loss(w, b):
        return 0.5 * torch.mean(torch.sum(torch.square(w - b), -1))

    def make(**kw):
        return FederatedSession(make_algorithm("ldp-fedexp-gauss", clip_norm=0.3, sigma=0.21),
                                sample_loss, np.zeros(D, np.float32), samples,
                                train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                                local=LocalSpec(batch_size=4, epochs=2, momentum=0.5),
                                cohort=cohort, device="cpu", **kw)

    runs_close(make(**STREAM).run(SEED), make().run(SEED))


def test_tree_model_streams():
    rng = np.random.default_rng(1)
    params = {"W": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    batches = {"x": rng.standard_normal((M, 8, 4)).astype(np.float32),
               "y": rng.standard_normal((M, 8, 3)).astype(np.float32)}

    def loss(p, b):
        err = b["x"] @ p["W"] + p["b"] - b["y"]
        return 0.5 * torch.mean(torch.sum(err ** 2, -1))

    def make(**kw):
        return FederatedSession(make_algorithm("cdp-fedexp", clip_norm=0.3, sigma=0.05,
                                               num_clients=M), loss, params, batches,
                                train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                                device="cpu", **kw)

    got, want = make(**STREAM).run(SEED), make().run(SEED)
    for k in params:
        close_vec(got.final_w[k], want.final_w[k])


@pytest.mark.parametrize("name,cohort", [("ldp-fedexp-gauss", None), ("cdp-fedexp", None),
                                         ("dp-scaffold", None),
                                         ("ldp-fedexp-gauss", CohortSpec(q=0.5, gather=True)),
                                         ("cdp-fedexp", CohortSpec(q=0.5))], ids=str)
def test_faulted_stream_equals_faulted_eager(data, name, cohort):
    fault = FaultSpec(**FAULT)
    want = session(data, name, cohort=cohort, fault=fault).run(SEED)
    got = session(data, name, cohort=cohort, fault=fault, **STREAM).run(SEED)
    runs_close(got, want)
    clean = session(data, name, cohort=cohort, **STREAM).run(SEED)
    assert not torch.equal(clean.final_w, got.final_w)


def test_watchdog_trips_the_streamed_run_as_the_eager_one(data):
    fault = FaultSpec(watchdog=True, eta_max=1.5)
    want = session(data, "fedexp", fault=fault).run(SEED)
    got = session(data, "fedexp", fault=fault, **STREAM).run(SEED)
    assert got.fault_round == want.fault_round == 0
    runs_close(got, want)


@pytest.mark.parametrize("name,cohort", [("cdp-fedexp-adaptive-clip", None),
                                         ("dp-scaffold", CohortSpec(q=0.5, gather=True))],
                         ids=str)
def test_a_killed_streamed_run_resumes_bit_for_bit(data, name, cohort, tmp_path):
    full = session(data, name, cohort=cohort, **STREAM).run(
        SEED, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=2)
    session(data, name, cohort=cohort, rounds=2, **STREAM).run(
        SEED, checkpoint_dir=str(tmp_path / "killed"), checkpoint_every=2)
    resumed = session(data, name, cohort=cohort, **STREAM).resume(str(tmp_path / "killed"))
    assert same_run(resumed, full)


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_rollback_drives_the_streamed_round(data, host, tmp_path):
    """A divergence planted in attempt 0 rolls back to the checkpoint at
    round 0 and reruns: the recovered run equals the unkilled one in bits,
    on device rows and on a host source."""
    fault = FaultSpec(watchdog=True)
    batches = HostArraySource({"x": data["x"], "y": data["y"]}) if host else None
    want = session(data, "ldp-fedexp-gauss", fault=fault, batches=batches, **STREAM).run(SEED)
    s = session(data, "ldp-fedexp-gauss", fault=fault, batches=batches, **STREAM)

    def poison(carry, attempt):
        if attempt > 0:
            return carry
        w = carry[0].clone()
        w[0] = float("inf")
        return (w,) + tuple(carry[1:])

    s._inject_divergence = poison
    got = s.run(SEED, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                on_divergence=RecoveryPolicy(max_retries=2))
    assert got.fault_round is None and s._rounds_retried == 1
    assert same_run(got, want)
    if host:
        resumed = session(data, "ldp-fedexp-gauss", fault=fault, batches=batches,
                          **STREAM).resume(str(tmp_path))
        assert same_run(resumed, want)


def test_run_batched_streams_the_seeds_one_after_another(data):
    s = session(data, "ldp-fedexp-gauss", rounds=2, **STREAM)
    swept = s.run_batched([3, 4, 5])
    assert swept.final_w.shape == (3, D) and swept.eta_history.shape == (3, 2)
    for i, seed in enumerate([3, 4, 5]):
        one = s.run(seed)
        assert torch.equal(swept.final_w[i], one.final_w)
        assert same(swept.eta_history[i], one.eta_history)
    for kw in (dict(batched_w0=True), dict(batched_data=True)):
        with pytest.raises(ValueError, match="per-seed w0/data axes are not supported"):
            s.run_batched([0, 1], **kw)


def test_the_round_draws_as_the_eager_round(data):
    """A streamed round reads the round generator as the eager round does:
    after both, the generators are in the same state."""
    for cohort in (None, CohortSpec(q=0.3), CohortSpec(q=0.3, gather=True)):
        s = session(data, "ldp-fedexp-privunit", cohort=cohort, **STREAM)
        e = session(data, "ldp-fedexp-privunit", cohort=cohort)
        w = torch.zeros(D)
        g1, g2 = round_generator(SEED, 0), round_generator(SEED, 0)
        s._step()(w, (), g1, 0, s.client_batches, ETA_L)
        e._step()(w, (), g2, 0, e.client_batches, ETA_L)
        assert torch.equal(g1.get_state(), g2.get_state())


def test_chunk_rows_are_the_chunk_grid(data):
    """The engine's chunk j is chunk_cohort's chunk j, rows and mask, in bits."""
    batches = {k: torch.tensor(data[k]) for k in ("x", "y")}
    grid, gmask = chunk_cohort(batches, CHUNK)
    plan = srv.chunk_plan(torch.ones(M), None, CHUNK)
    chunks = list(srv._device_chunks(batches, plan))
    assert len(chunks) == gmask.shape[0] == 3
    for j, (rows, (idx, mask_j, start)) in enumerate(chunks):
        assert start == j * CHUNK and torch.equal(mask_j, gmask[j])
        for k in batches:
            assert torch.equal(rows[k], grid[k][j])


def test_the_gathered_plan_packs_the_slots_a_chunk_at_a_time():
    cohort = CohortSpec(q=0.3, gather=True)
    mask = cohort.round_mask(round_generator(SEED, 0), M)
    plan = list(srv.chunk_plan(mask, cohort, 5))
    cap = cohort.resolved_cap(M)
    assert len(plan) == -(-cap // 5) and all(p[0].shape == (5,) for p in plan)
    slots = torch.cat([p[0] for p in plan])
    on = torch.nonzero(mask).flatten()
    assert torch.equal(slots[:on.numel()], on)
    assert float(torch.cat([p[1] for p in plan]).sum()) == float(mask.sum())
    assert all(torch.equal(p[0], p[2]) for p in plan)


@pytest.mark.parametrize("chunk,want", [(CHUNK, CHUNK), (1000, M), ("auto", M)])
def test_the_chunk_is_resolved_and_capped_at_m(data, chunk, want):
    s = session(data, "fedexp", engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk))
    if chunk == "auto":
        assert s.stream.chunk_clients == tmesh.auto_chunk_clients(D, s._client_bytes(),
                                                                  device="cpu")
        assert s._client_bytes() == 4 * (D + 1)
    plan = list(srv.chunk_plan(torch.ones(M), None, min(s.stream.chunk_clients, M)))
    assert plan[0][0].shape == (want,)


def test_refusals(data):
    with pytest.raises(ValueError, match="a non-default StreamSpec requires engine='stream'"):
        session(data, "fedexp", stream=StreamSpec(8))
    host = HostArraySource({"x": data["x"], "y": data["y"]})
    with pytest.raises(ValueError, match=r"DataSpec\(kind='npz'\) contradicts the client data "
                                         r"actually passed \('host'\)"):
        session(data, "fedexp", batches=host, data=DataSpec(kind="npz"), **STREAM)
    with pytest.raises(ValueError, match=r"contradicts the client data actually passed "
                                         r"\('device'\)"):
        session(data, "fedexp", data=DataSpec(kind="host"))
    with pytest.raises(ValueError, match="a 'host' ClientDataSource requires engine='stream'"):
        session(data, "fedexp", batches=host)
    with pytest.raises(ValueError, match="fault injection requires device-resident batches"):
        session(data, "fedexp", batches=host, fault=FaultSpec(dropout=0.1), **STREAM)
    # the watchdog alone reads only the carry: a host source takes it
    session(data, "fedexp", batches=host, fault=FaultSpec(watchdog=True), **STREAM)


def test_large_cohort_small_chunk():
    m, d, chunk = 3000, 32, 256
    targets = np.random.default_rng(5).standard_normal((m, d)).astype(np.float32)

    def quad_loss(w, b):
        return 0.5 * torch.sum(torch.square(w - b))

    def make(**kw):
        return FederatedSession(make_algorithm("ldp-fedexp-gauss", clip_norm=0.3, sigma=0.21),
                                quad_loss, np.zeros(d, np.float32), targets,
                                train=TrainSpec(rounds=2, tau=1, eta_l=0.5), device="cpu", **kw)

    got = make(engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk)).run(SEED)
    runs_close(got, make().run(SEED))


# ---------------------------------------------------------------------------
# the chunked kernel wrapper (its plain path on CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
@pytest.mark.parametrize("chunk", [7, 11, M])
def test_chunked_sums_equal_one_call(rows, mode, chunk):
    u, noise, mask, _ = (torch.tensor(x) for x in rows)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=9, noise_sigma=0.2)}.get(mode, {})
    one = ops.dp_aggregate_sums(u, 0.3, row_gate=mask, **kw)
    got = ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=chunk, row_gate=mask, **kw)
    plain = ref.dp_aggregate_sums_chunked_ref(u, 0.3, chunk_m=chunk, row_gate=mask, **kw)
    for a, b, c in zip(got, one, plain):
        close_vec(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
@pytest.mark.parametrize("chunk", [7, 11, 16])
def test_chunked_sums_gate_the_padding_of_an_ungated_call(rows, mode, chunk):
    """Without a row gate the padded last chunk is gated by its valid rows
    alone: the sums are the ungated one-call sums."""
    u, noise, _, _ = (torch.tensor(x) for x in rows)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=9, noise_sigma=0.2)}.get(mode, {})
    one = ops.dp_aggregate_sums(u, 0.3, **kw)
    got = ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=chunk, **kw)
    for a, b in zip(got, one):
        close_vec(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_chunked_sums_over_slots_equal_the_gathered_block(rows, fused):
    u, _, mask, _ = (torch.tensor(x) for x in rows)
    from repro_torch.fedsim import gather_slots
    slots, slot_mask, _ = gather_slots(mask, 32)
    kw = dict(noise_seed=9, noise_sigma=0.2) if fused else {}
    block = ops.dp_aggregate_sums(u.index_select(0, slots), 0.3, row_gate=slot_mask,
                                  row_ids=slots if fused else None, **kw)
    got = ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=5, slots=slots, slot_mask=slot_mask, **kw)
    dense = ops.dp_aggregate_sums(u, 0.3, row_gate=mask, **kw)
    for a, b, c in zip(got, block, dense):
        close_vec(a, b)
        close_vec(a, c)


def test_chunked_sums_refusals(rows):
    u = torch.tensor(rows[0])
    with pytest.raises(ValueError, match="LDP noise"):   # compression takes no per-row noise
        ops.dp_aggregate_sums_chunked(u, 0.3, u, chunk_m=4, compress_fn=lambda x: x)
    with pytest.raises(ValueError, match="slots requires slot_mask"):
        ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=4, slots=torch.arange(4))
    with pytest.raises(ValueError, match="chunk_m must be >= 1"):
        ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=0)
    with pytest.raises(ValueError, match="one row per reduced row"):
        ops.dp_aggregate_sums_chunked(u, 0.3, u[:5], chunk_m=4)
