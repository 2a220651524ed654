"""A streamed PrivUnit round draws its directions' normal a chunk at a time.

``PrivUnitLDP`` keys the N(0, 1) normal of client i, column j by (the
round's seed, i, j), as the Gaussian LDP noise is keyed (the noise-only
kernel on the card, ``ref.ldp_noise_ref`` on the CPU).  So a streamed round
at chunk c asks for c rows at a time and never holds an (M, d) normal, and
its rounds equal the dense eager rounds at rtol 1e-5 (an array's atol 1e-5
times its largest entry): the same draws, sums in other orders.  Every
request of the noise generator and every ``torch.randn`` of the run is
recorded, and none may have M rows of d columns.  A gathered block draws
exactly its clients' rows of the dense normal, in bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import distance_to_opt, linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    EngineSpec,
    FederatedSession,
    StreamSpec,
    TrainSpec,
)
from repro_torch.kernels.dp_aggregate import ops  # noqa: E402
from repro_torch.kernels.dp_aggregate.ref import ldp_noise_ref  # noqa: E402

M, D, TAU, ETA_L, ROUNDS, CHUNK = 44, 24, 2, 0.1, 4, 16
NAMES = ("ldp-fedexp-privunit", "dp-fedavg-privunit", "privunit-fedexp-adaptive-clip")


def close_vec(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(3)
    w_star = torch.randn(D, generator=g)
    x = torch.randn(M, D, generator=g)                      # one sample a client
    y = x @ w_star + 0.1 * torch.randn(M, generator=g)
    return {"x": x, "y": y, "w_star": w_star}


def session(data, name, **kw):
    alg = make_algorithm(name, clip_norm=1.0, dim=D, eps0=2.0, eps1=2.0, eps2=2.0)
    return FederatedSession(alg, linreg_loss, np.zeros(D, np.float32),
                            {"x": data["x"], "y": data["y"]},
                            train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                            eval_fn=distance_to_opt(data["w_star"]), device="cpu", **kw)


class Recorder:
    """Rows of every normal the run draws: the noise generator's requests
    and every ``torch.randn`` of two or more dimensions."""

    def __init__(self, monkeypatch):
        self.rows = []
        gen, randn = ops.generate_ldp_noise, torch.randn

        def noise(m, d, *args, **kw):
            self.rows.append((m, d))
            return gen(m, d, *args, **kw)

        def recorded_randn(*shape, **kw):
            dims = tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                                                  torch.Size)) \
                else shape
            if len(dims) >= 2:
                self.rows.append(tuple(dims))
            return randn(*shape, **kw)

        monkeypatch.setattr(ops, "generate_ldp_noise", noise)
        monkeypatch.setattr(torch, "randn", recorded_randn)


@pytest.mark.parametrize("name", NAMES)
def test_a_streamed_round_draws_no_m_row_normal_and_equals_the_dense_round(
        data, name, monkeypatch):
    dense_rec = Recorder(monkeypatch)
    want = session(data, name).run(5)
    assert (M, D) in dense_rec.rows          # the dense round draws all M rows at once
    rec = Recorder(monkeypatch)
    got = session(data, name, engine=EngineSpec(engine="stream"),
                  stream=StreamSpec(chunk_clients=CHUNK)).run(5)
    assert rec.rows and all(r[0] <= CHUNK for r in rec.rows), rec.rows
    for f in ("final_w", "last_w", "eta_history", "metric_history"):
        close_vec(getattr(got, f), getattr(want, f))


def test_a_sampled_stream_equals_the_sampled_eager_run(data, monkeypatch):
    name, cohort = "ldp-fedexp-privunit", CohortSpec(q=0.5, gather=True)
    want = session(data, name, cohort=cohort).run(6)
    rec = Recorder(monkeypatch)
    got = session(data, name, cohort=cohort, engine=EngineSpec(engine="stream"),
                  stream=StreamSpec(chunk_clients=CHUNK)).run(6)
    assert all(r[0] <= CHUNK for r in rec.rows), rec.rows
    for f in ("final_w", "eta_history"):
        close_vec(getattr(got, f), getattr(want, f))


def test_a_block_draws_its_clients_rows_of_the_dense_normal():
    alg = make_algorithm("ldp-fedexp-privunit", clip_norm=1.0, dim=D, eps0=2.0, eps1=2.0,
                         eps2=2.0)
    noise = alg.draw_noise(round_generator(2, 1), M, D, "cpu")
    assert noise.g is None
    dense = alg.mechanism._normal(noise, (M, D), 0, "cpu")
    assert torch.equal(dense, ldp_noise_ref(M, D, noise.seed, 1.0))
    assert torch.equal(alg.mechanism._normal(noise, (CHUNK, D), 16, "cpu"), dense[16:32])
    ids = torch.tensor([3, 40, 7, 0])
    assert torch.equal(alg.mechanism._normal(noise, (4, D), ids, "cpu"), dense[ids])
    # a padded chunk past M draws rows keyed past M, which its mask zeroes
    tail = alg.mechanism._normal(noise, (CHUNK, D), 32, "cpu")
    assert torch.equal(tail[:M - 32], dense[32:])
