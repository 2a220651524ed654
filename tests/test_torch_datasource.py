"""The port's client data sources on the CPU: against the JAX package's, and
host-resident streamed sessions against device-resident ones.

Every source's ``fetch`` returns the JAX source's rows exactly, on the same
numpy data (an ``.npz`` archive written and read by both).  A session on an
``ArraySource`` is the session on the bare data, bit for bit; a streamed
session on a host, npz or synthetic source equals the device-resident
streamed session in bits, dense and gathered, at every prefetch depth; the
staging fetches a chunk at a time, the next only after the chunk before was
handed on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.fedsim import data as jdata  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    ArraySource,
    ClientDataSource,
    CohortSpec,
    DataSpec,
    EngineSpec,
    FederatedSession,
    HostArraySource,
    NpzSource,
    StreamSpec,
    SyntheticSource,
    TrainSpec,
    as_data_source,
)
from repro_torch.fedsim import data as tdata  # noqa: E402
from repro_torch.fedsim import server as srv  # noqa: E402

M, D, ROUNDS, CHUNK = 44, 24, 4, 16
SEED = 11
IDX = np.array([5, 0, 43, 5, 17, 17, 2])   # out of order, with repeats
RESULT = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(4)
    return {"x": rng.standard_normal((M, 3, D)).astype(np.float32),
            "y": rng.standard_normal((M, 3)).astype(np.float32)}


def closed_form(idx):
    """e8's generated rows: a pure function of the client index."""
    mix = (np.arange(1, D + 1, dtype=np.int64) * 2654435761) % (2**31)
    g = (np.asarray(idx, np.int64)[:, None] + 1) * mix[None, :]
    return {"t": ((g % 2039) / 1019.5 - 1.0).astype(np.float32)}


def rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_array_source_fetches_jax_rows(arrays):
    t = ArraySource({k: torch.tensor(v) for k, v in arrays.items()})
    j = jdata.ArraySource({k: jnp.asarray(v) for k, v in arrays.items()})
    assert (t.kind, t.num_clients) == (j.kind, j.num_clients) == ("device", M)
    rows_equal(t.fetch(IDX), j.fetch(IDX))


def test_host_array_source_fetches_jax_rows(arrays):
    t, j = HostArraySource(arrays), jdata.HostArraySource(arrays)
    assert (t.kind, t.num_clients) == (j.kind, j.num_clients) == ("host", M)
    rows_equal(t.fetch(IDX), j.fetch(IDX))
    # tensors are read to the host once
    rows_equal(HostArraySource({k: torch.tensor(v) for k, v in arrays.items()}).fetch(IDX),
               j.fetch(IDX))


def test_npz_source_round_trip_fetches_jax_rows(arrays, tmp_path):
    path = tmp_path / "clients.npz"
    np.savez(path, **arrays)
    t, j = NpzSource(str(path)), jdata.NpzSource(str(path))
    assert (t.kind, t.num_clients) == (j.kind, j.num_clients) == ("npz", M)
    rows_equal(t.fetch(IDX), j.fetch(IDX))
    rows_equal(t.fetch(IDX), {k: v[IDX] for k, v in arrays.items()})


def test_synthetic_source_fetches_jax_rows():
    t, j = SyntheticSource(closed_form, M), jdata.SyntheticSource(closed_form, M)
    assert (t.kind, t.num_clients) == (j.kind, j.num_clients) == ("synthetic", M)
    rows_equal(t.fetch(IDX), j.fetch(IDX))
    rows_equal(t.fetch(IDX), t.fetch(IDX.copy()))


def test_sources_refuse_as_jax(arrays, tmp_path):
    for make in (lambda mod: mod.SyntheticSource(closed_form, 0),
                 lambda mod: mod.HostArraySource({"x": arrays["x"], "y": arrays["y"][:3]}),
                 lambda mod: mod.HostArraySource({})):
        with pytest.raises(ValueError) as jerr:
            make(jdata)
        with pytest.raises(ValueError) as terr:
            make(tdata)
        assert str(terr.value) == str(jerr.value)
    empty = tmp_path / "empty.npz"
    np.savez(empty)
    with pytest.raises(ValueError, match="holds no arrays"):
        NpzSource(str(empty))
    base = ClientDataSource()
    with pytest.raises(NotImplementedError):
        base.fetch(IDX)


def test_as_data_source(arrays):
    src = HostArraySource(arrays)
    assert as_data_source(src) is src and as_data_source(arrays) is None
    assert jdata.as_data_source(arrays) is None


# ---------------------------------------------------------------------------
# sessions on sources
# ---------------------------------------------------------------------------

def quad_loss(w, b):
    return 0.5 * torch.sum(torch.square(w - b["t"]))


def e8_session(source, cohort=None, chunk=CHUNK, prefetch=2):
    """e8's ldp-fedexp-gauss session at the test size, streamed."""
    return FederatedSession(make_algorithm("ldp-fedexp-gauss", clip_norm=0.3, sigma=0.21),
                            quad_loss, np.zeros(D, np.float32), source,
                            train=TrainSpec(rounds=ROUNDS, tau=1, eta_l=0.5),
                            engine=EngineSpec(engine="stream"), stream=StreamSpec(chunk),
                            cohort=cohort, device="cpu",
                            data=DataSpec(kind=getattr(source, "kind", "device"),
                                          prefetch=prefetch))


def same_run(a, b):
    return all(torch.equal(torch.nan_to_num(getattr(a, f), nan=7.0),
                           torch.nan_to_num(getattr(b, f), nan=7.0)) for f in RESULT)


def _sources(tmp_path):
    rows = closed_form(np.arange(M))
    np.savez(tmp_path / "e8.npz", **rows)
    return {"host": HostArraySource(rows), "npz": NpzSource(str(tmp_path / "e8.npz")),
            "synthetic": SyntheticSource(closed_form, M)}


@pytest.mark.parametrize("cohort", [None, CohortSpec(q=0.3), CohortSpec(q=0.3, gather=True),
                                    CohortSpec(size=5, replace=True)], ids=str)
def test_host_sources_equal_the_device_stream_at_every_depth(cohort, tmp_path):
    device = {"t": torch.tensor(closed_form(np.arange(M))["t"])}
    want = e8_session(device, cohort).run(SEED)
    for kind, source in _sources(tmp_path).items():
        for prefetch in (1, 2, 3):
            s = e8_session(source, cohort, prefetch=prefetch)
            assert s.data == DataSpec(kind=kind, prefetch=prefetch)
            assert same_run(s.run(SEED), want), (kind, prefetch)


@pytest.mark.parametrize("engine", ["eager", "stream"])
def test_array_source_is_the_bare_data_in_bits(engine):
    device = {"t": torch.tensor(closed_form(np.arange(M))["t"])}

    def make(batches):
        return FederatedSession(make_algorithm("cdp-fedexp", clip_norm=0.3, sigma=0.2,
                                               num_clients=M), quad_loss,
                                np.zeros(D, np.float32), batches,
                                train=TrainSpec(rounds=ROUNDS, tau=1, eta_l=0.5),
                                engine=EngineSpec(engine=engine),
                                cohort=CohortSpec(q=0.4, gather=True), device="cpu")

    s = make(ArraySource(device))
    assert s.data.kind == "device" and isinstance(s.client_batches, dict)
    assert same_run(s.run(SEED), make(device).run(SEED))


class CountingSource(SyntheticSource):
    """A synthetic source that logs its fetches."""

    def __init__(self, log):
        super().__init__(closed_form, M)
        self.log = log

    def fetch(self, idx):
        self.log.append(("fetch", len(idx)))
        return super().fetch(idx)


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_staging_fetches_a_chunk_ahead_of_the_work(prefetch):
    log = []
    plan = list(srv.chunk_plan(torch.ones(M), None, CHUNK))
    for j, (rows, entry) in enumerate(srv.host_chunks(CountingSource(log), plan, "cpu",
                                                      prefetch)):
        assert torch.equal(rows["t"], torch.tensor(closed_form(entry[0].numpy())["t"]))
        log.append(("work", j))
    fetches_before = [sum(1 for e in log[:log.index(("work", j))] if e[0] == "fetch")
                      for j in range(len(plan))]
    assert fetches_before == [min(len(plan), prefetch + j) for j in range(len(plan))]


def test_a_host_source_is_fetched_a_chunk_at_a_time():
    log = []
    s = e8_session(CountingSource(log), CohortSpec(q=0.3, gather=True), chunk=5)
    s.run(SEED)
    assert isinstance(s.client_batches, CountingSource) and s.num_clients == M
    # every fetch is one slot chunk of a round, never the cohort
    assert log and {n for _, n in log} == {5}


def test_auto_chunk_counts_a_fetched_row():
    s = e8_session(SyntheticSource(closed_form, M), chunk="auto")
    assert s._client_bytes() == 4 * D
    assert s.stream.chunk_clients == ((4 << 30) // 4) // (8 * D + 4 * D)
