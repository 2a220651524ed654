"""The port's compressed communication (rand-k, count-sketch, error feedback)
against the JAX package's, on the CPU.

Against JAX, at rtol 1e-5 (a vector's atol 1e-5 times its largest entry),
with the port fed JAX's plan (``aggregation.plan(fold_in(key,
COMPRESS_TAG), d)``) and noise (``round_noise_of``): every function of
``core/compression.py`` (the median at depth 2, 3 and 4, ``topk_select`` on
tied integers, exact where the arithmetic is); ``partial_clip_moments``,
``raw_moments``, ``streamed_clip_moments`` and the chunked wrapper with
``compress_fn``; the compressed ``local_moments`` of the 7 compression-legal
names; one round and a 4-round session of ``fedavg`` and ``cdp-fedexp``
(JAX's ``FAST_PARITY``) under rand-k and the sketch, eager, Bernoulli
sampled, gathered and streamed on a ragged grid (chunk 16); the
error-feedback carry over 4 rounds; the refusals and the names.

Inside the port: sketch additivity in bits on integer rows, rand-k's
inclusion frequency k/d over its own draws, the scalar moments equal to the
dense ones for the 7 names, lossless rand-k = the dense run, stream = eager
and gathered = dense for the 7 names, ``run_batched``, resume and rollback
in bits, a faulted compressed round against JAX's.

The JAX package's sharded and scan engines have no counterpart in the port
yet (ROADMAP.md, queue 1, items 16 and 20), so its tests of those engines
have none here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compose as jcomp  # noqa: E402
from repro.core import compression as jcz  # noqa: E402
from repro.core.fedexp import make_algorithm as jax_make  # noqa: E402
from repro.data.synthetic import linreg_loss as jax_loss  # noqa: E402
from repro.data.synthetic import make_synthetic_linreg as jax_data  # noqa: E402
from repro.fedsim import EngineSpec as JaxEngine  # noqa: E402
from repro.fedsim import FederatedSession as JaxSession  # noqa: E402
from repro.fedsim import StreamSpec as JaxStream  # noqa: E402
from repro.fedsim import TrainSpec as JaxTrain  # noqa: E402
from repro.fedsim import faults as jfaults  # noqa: E402
from repro.fedsim import local as jlocal  # noqa: E402
from repro.fedsim.server import _round_step  # noqa: E402
from repro.fedsim.specs import CohortSpec as JaxCohort  # noqa: E402
from repro.fedsim.specs import FaultSpec as JaxFault  # noqa: E402
from repro.kernels.dp_aggregate import ops as jops  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import compose as tcomp  # noqa: E402
from repro_torch.core import compression as tcz  # noqa: E402
from repro_torch.core.algorithm import round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import (  # noqa: E402
    CohortSpec,
    EngineSpec,
    FaultSpec,
    FederatedSession,
    LocalSpec,
    RecoveryPolicy,
    StreamSpec,
    TrainSpec,
)
from repro_torch.fedsim import server as srv  # noqa: E402
from repro_torch.fedsim.local import cohort_updates  # noqa: E402
from repro_torch.fedsim.specs import COMPRESS_TAG  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops  # noqa: E402
from test_torch_moments import close, close_vec, round_noise_of  # noqa: E402

# JAX's test geometry: M not a multiple of the 16-client chunk
M, D, TAU, ETA_L, ROUNDS, CHUNK = 44, 24, 2, 0.1, 4, 16
K = 8                      # rand-k keeps 8 of 24 coordinates
WIDTH, DEPTH = 6, 3        # sketch: 3 tables of width 6
SEED = 7

# the compression-legal registry names (JAX's COMPRESS_OK)
COMPRESS_OK = {
    "fedavg": {},
    "fedexp": {},
    "dp-fedavg-cdp": dict(clip_norm=0.3, sigma=0.2, num_clients=M),
    "cdp-fedexp": dict(clip_norm=0.3, sigma=0.2, num_clients=M),
    "dp-fedadam-cdp": dict(clip_norm=0.3, sigma=0.2, num_clients=M, server_lr=0.05),
    "cdp-fedexp-adaptive-clip": dict(z_mult=0.5, num_clients=M, dim=D),
    "cdp-fedmom": dict(clip_norm=0.3, sigma=0.2, num_clients=M),
}
LDP_NAMES = {
    "dp-fedavg-ldp-gauss": dict(clip_norm=0.3, sigma=0.21),
    "ldp-fedexp-gauss": dict(clip_norm=0.3, sigma=0.21),
    "dp-fedavg-privunit": dict(clip_norm=0.3, eps0=2.0, eps1=2.0, eps2=2.0, dim=D),
    "ldp-fedexp-privunit": dict(clip_norm=0.3, eps0=2.0, eps1=2.0, eps2=2.0, dim=D),
    "ldp-gauss-fedadam": dict(clip_norm=0.3, sigma=0.21, server_lr=0.05),
    "privunit-fedexp-adaptive-clip": dict(eps0=2.0, eps1=2.0, eps2=2.0, dim=D, c0=0.5),
    "ldp-fedexp-schedule": dict(clip_norm=0.3, sigma=0.21, decay=0.97),
}
FAST_PARITY = ("fedavg", "cdp-fedexp")
AGGS = {
    "randk": lambda pkg: pkg.RandKAggregation(k=K),
    "sketch": lambda pkg: pkg.CountSketchAggregation(width=WIDTH, depth=DEPTH),
    "sketch-ef": lambda pkg: pkg.CountSketchAggregation(width=WIDTH, depth=DEPTH, top_k=D // 2,
                                                        error_feedback=True),
}
ENGINES = {
    "eager": ({}, {}),
    "bernoulli": (dict(cohort=CohortSpec(q=0.5)), dict(cohort=JaxCohort(q=0.5))),
    "gathered": (dict(cohort=CohortSpec(q=0.5, gather=True)),
                 dict(cohort=JaxCohort(q=0.5, gather=True))),
    "stream": (dict(engine=EngineSpec(engine="stream"), stream=StreamSpec(CHUNK)),
               dict(engine=JaxEngine(engine="stream"), stream=JaxStream(chunk_clients=CHUNK))),
}
RESULT = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


def tcompressed(name, agg, **kw):
    alg = make_algorithm(name, **(COMPRESS_OK[name] if not kw else kw))
    return alg if agg is None else tcomp.with_compression(alg, AGGS[agg](tcomp))


def jcompressed(name, agg):
    alg = jax_make(name, **COMPRESS_OK[name])
    return alg if agg is None else jcomp.with_compression(alg, AGGS[agg](jcomp))


@pytest.fixture(scope="module")
def data():
    d = jax_data(jax.random.PRNGKey(3), M, D)
    return {k: np.array(getattr(d, k)) for k in ("x", "y")}


def tbatches(data):
    return {k: torch.tensor(v) for k, v in data.items()}


def jbatches(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def same(a, b):
    """Equal in bits, NaN where both are NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def same_run(a, b):
    return all(same(getattr(a, f), getattr(b, f)) for f in RESULT)


def runs_close(got, want, rtol=1e-5):
    for f in ("final_w", "last_w", "eta_history"):
        close_vec(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), rtol)


# ---------------------------------------------------------------------------
# core/compression.py
# ---------------------------------------------------------------------------

def test_the_tag_is_the_jax_packages():
    assert tcz.COMPRESS_TAG == jcz.COMPRESS_TAG == COMPRESS_TAG == 2**31 - 4


@pytest.mark.parametrize("d,k", [(24, 8), (25, 8), (24, 24), (24, 30)])
def test_randk_plan_draws_k_distinct_coordinates(d, k):
    a = tcz.randk_plan(tcz.plan_generator(5), d, k)
    b = tcz.randk_plan(tcz.plan_generator(5), d, k)
    assert torch.equal(a, b) and a.dtype == torch.int64
    assert a.shape == (min(k, d),) and len(set(a.tolist())) == min(k, d)
    assert int(a.min()) >= 0 and int(a.max()) < d
    if k >= d:
        assert torch.equal(a, torch.arange(d))
    elif d % k == 0:   # stratified: one coordinate in each block of d/k
        assert torch.equal(a // (d // k), torch.arange(k))
    assert not torch.equal(a, tcz.randk_plan(tcz.plan_generator(6), d, k)) or k >= d


@pytest.mark.parametrize("d,k", [(24, 8), (25, 8)])
def test_randk_keeps_each_coordinate_with_probability_k_over_d(d, k):
    n = 3000
    hits = torch.zeros(d)
    for r in range(n):
        hits[tcz.randk_plan(tcz.plan_generator(r), d, k)] += 1
    p = k / d
    assert torch.all(torch.abs(hits / n - p) < 5 * np.sqrt(p * (1 - p) / n))


@pytest.mark.parametrize("d,k", [(24, 8), (25, 8), (24, 24)])
def test_randk_compress_and_decompress_equal_jax(d, k):
    idx = jcz.randk_plan(jax.random.PRNGKey(d + k), d, min(k, d))
    u = np.random.default_rng(0).standard_normal((5, d)).astype(np.float32)
    tidx = torch.tensor(np.asarray(idx))
    got = tcz.randk_compress(torch.tensor(u), tidx)
    want = jcz.randk_compress(jnp.asarray(u), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tcz.randk_decompress(got[2], tidx, d).numpy(),
                                  np.asarray(jcz.randk_decompress(want[2], idx, d)))


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_sketch_compress_and_decompress_equal_jax(depth):
    d, width = 40, 7
    h, s = jcz.sketch_plan(jax.random.PRNGKey(depth), d, width, depth)
    th, ts = torch.tensor(np.asarray(h)), torch.tensor(np.asarray(s))
    rng = np.random.default_rng(depth)
    u = rng.standard_normal((6, d)).astype(np.float32)
    want = np.asarray(jcz.sketch_compress(jnp.asarray(u), (h, s), width))
    got = tcz.sketch_compress(torch.tensor(u), (th, ts), width)
    assert got.shape == (6, depth * width)
    close_vec(got.numpy(), want)
    plan = tcz.SketchPlan(th, ts, tcz.bucket_slots(th, width))
    assert torch.equal(tcz.sketch_compress(torch.tensor(u), plan, width), got)
    assert torch.equal(tcz.sketch_compress(torch.tensor(u[1]), plan, width), got[1])
    comp = want.sum(axis=0)
    dec = tcz.sketch_decompress(torch.tensor(comp), plan, d)
    np.testing.assert_array_equal(dec.numpy(),
                                  np.asarray(jcz.sketch_decompress(jnp.asarray(comp), (h, s), d)))


@pytest.mark.parametrize("depth", [2, 4])
def test_an_even_depth_median_averages_the_middle_pair(depth):
    """torch.median would return the lower middle value; jnp.median averages."""
    d, width = 5, 3
    h = torch.tensor([[0, 1, 2, 0, 1]] * depth)
    s = torch.ones(depth, d)
    tables = torch.arange(depth * width, dtype=torch.float32).reshape(depth, width) * 1.5
    got = tcz.sketch_decompress(tables.reshape(-1), (h, s), d)
    est = torch.gather(tables, 1, h)
    want = np.median(est.numpy(), axis=0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, torch.median(est, dim=0).values)
    jwant = jcz.sketch_decompress(jnp.asarray(tables.reshape(-1).numpy()),
                                  (jnp.asarray(h.numpy()), jnp.asarray(s.numpy())), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
    tables[0, 1] = float("nan")      # a NaN among the values is the median, as in jnp
    got = tcz.sketch_decompress(tables.reshape(-1), (h, s), d)
    assert torch.isnan(got[[1, 4]]).all() and torch.isfinite(got[[0, 2, 3]]).all()


@pytest.mark.parametrize("k", [1, 3, 5, 9, 12])
def test_topk_select_keeps_k_and_breaks_ties_as_jax(k):
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, 16).astype(np.float32)   # many ties, zeros and signs
    got = tcz.topk_select(torch.tensor(x), k)
    want = np.asarray(jcz.topk_select(jnp.asarray(x), k))
    np.testing.assert_array_equal(got.numpy(), want)
    kept = np.flatnonzero(got.numpy() != 0)
    assert len(kept) <= k and np.all(np.abs(x[kept]) >= np.sort(np.abs(x))[::-1][k - 1])
    assert torch.equal(tcz.topk_select(torch.tensor(x), 16), torch.tensor(x))


def test_the_sketch_is_additive_in_bits_on_integer_rows():
    d, width = 64, 5
    plan = tcz.sketch_plan(tcz.plan_generator(1), d, width, 3)
    rng = np.random.default_rng(2)
    a, b = (torch.tensor(rng.integers(-50, 50, (7, d)).astype(np.float32)) for _ in range(2))
    assert torch.equal(tcz.sketch_compress(a, plan, width) + tcz.sketch_compress(b, plan, width),
                       tcz.sketch_compress(a + b, plan, width))
    assert torch.equal(tcz.sketch_compress(a, plan, width).sum(0),
                       tcz.sketch_compress(a.sum(0), plan, width))
    assert torch.equal(tcz.sketch_compress(torch.zeros(3, d), plan, width), torch.zeros(3, 15))


def test_sketch_plan_tables():
    d, width, depth = 50, 4, 3
    plan = tcz.sketch_plan(tcz.plan_generator(9), d, width, depth)
    again = tcz.sketch_plan(tcz.plan_generator(9), d, width, depth)
    assert all(torch.equal(x, y) for x, y in zip(plan, again))
    assert plan.h.shape == plan.s.shape == (depth, d)
    assert set(plan.s.unique().tolist()) == {-1.0, 1.0}
    for t in range(depth):     # every column once, in its bucket, in ascending order
        for b in range(width):
            cols = plan.slots[t, b][plan.slots[t, b] < d]
            assert torch.equal(cols, torch.nonzero(plan.h[t] == b).flatten())
        assert int((plan.slots[t] < d).sum()) == d


# ---------------------------------------------------------------------------
# The moment reductions with compress_fn
# ---------------------------------------------------------------------------

def _compressors(d):
    """(name, port compress_fn, JAX compress_fn) on JAX's plans."""
    idx = jcz.randk_plan(jax.random.PRNGKey(1), d, K)
    h, s = jcz.sketch_plan(jax.random.PRNGKey(2), d, WIDTH, DEPTH)
    tidx = torch.tensor(np.asarray(idx))
    tplan = (torch.tensor(np.asarray(h)), torch.tensor(np.asarray(s)))
    return [("randk", lambda u: tcz.randk_compress(u, tidx),
             lambda u: jcz.randk_compress(u, idx)),
            ("sketch", lambda u: tcz.sketch_compress(u, tplan, WIDTH),
             lambda u: jcz.sketch_compress(u, (h, s), WIDTH))]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_partial_clip_moments_compressed_equal_jax(which, masked, weighted):
    """Rand-k without a row bound, the sketch re-clipped to a bound that binds."""
    m, d = 37, 24
    bound = 0.25 if which else None
    rng = np.random.default_rng(4)
    u = (0.4 * rng.standard_normal((m, d))).astype(np.float32)
    u[3] *= 10.0
    mask = (rng.random(m) < 0.6).astype(np.float32) if masked else None
    weights = (0.2 + rng.random(m)).astype(np.float32) if weighted else None
    if masked:
        u[mask == 0] = np.nan     # a gated row never reaches a compressed sum
    _, tfn, jfn = _compressors(d)[which]
    jm = jagg.partial_clip_moments(
        jnp.asarray(u), 0.3, weight_mask=None if mask is None else jnp.asarray(mask),
        row_weights=None if weights is None else jnp.asarray(weights), backend="jnp",
        compress_fn=jfn, compress_row_bound=bound)
    tm = tagg.partial_clip_moments(
        torch.tensor(u), 0.3, weight_mask=None if mask is None else torch.tensor(mask),
        row_weights=None if weights is None else torch.tensor(weights), compress_fn=tfn,
        compress_row_bound=bound)
    assert tm.sum_c.shape == ((K,) if which == 0 else (WIDTH * DEPTH,))
    assert torch.isfinite(tm.sum_c).all()
    close_vec(tm.sum_c.numpy(), jm.sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tm, f), getattr(jm, f), what=f)
    dense = tagg.partial_clip_moments(
        torch.tensor(u), 0.3, weight_mask=None if mask is None else torch.tensor(mask),
        row_weights=None if weights is None else torch.tensor(weights), backend="torch")
    close(tm.sum_sq, dense.sum_sq_clipped)
    stats = tagg.fused_clip_aggregate(torch.tensor(np.nan_to_num(u)), 0.3, compress_fn=tfn,
                                      compress_row_bound=bound)
    plain = tagg.partial_clip_moments(torch.tensor(np.nan_to_num(u)), 0.3, compress_fn=tfn,
                                      compress_row_bound=bound).stats()
    assert torch.equal(stats.cbar, plain.cbar) and stats.cbar.shape == tm.sum_c.shape


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_raw_moments_compressed_equal_jax(which, masked):
    m, d = 31, 24
    rng = np.random.default_rng(5)
    u = rng.standard_normal((m, d)).astype(np.float32)
    mask = (rng.random(m) < 0.5).astype(np.float32) if masked else None
    if masked:
        u[mask == 0] = np.nan
    _, tfn, jfn = _compressors(d)[which]
    jm = jagg.raw_moments(jnp.asarray(u), None if mask is None else jnp.asarray(mask),
                          compress_fn=jfn)
    tm = tagg.raw_moments(torch.tensor(u), None if mask is None else torch.tensor(mask),
                          binary_mask=True, compress_fn=tfn)
    close_vec(tm.sum_c.numpy(), jm.sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tm, f), getattr(jm, f), what=f)


@pytest.mark.parametrize("chunk", [7, 16, 100])
@pytest.mark.parametrize("which", [0, 1])
def test_streamed_clip_moments_compressed_equal_jax(which, chunk):
    rng = np.random.default_rng(6)
    u = (0.3 * rng.standard_normal((M, D))).astype(np.float32)
    mask = (rng.random(M) < 0.6).astype(np.float32)
    _, tfn, jfn = _compressors(D)[which]
    bound = 0.3 * np.sqrt(DEPTH) if which else None
    jm = jagg.streamed_clip_moments(jnp.asarray(u), 0.3, chunk_clients=chunk,
                                    weight_mask=jnp.asarray(mask), backend="jnp",
                                    compress_fn=jfn, compress_row_bound=bound)
    tm = tagg.streamed_clip_moments(torch.tensor(u), 0.3, chunk_clients=chunk,
                                    weight_mask=torch.tensor(mask), compress_fn=tfn,
                                    compress_row_bound=bound)
    close_vec(tm.sum_c.numpy(), jm.sum_c)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(tm, f), getattr(jm, f), what=f)


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_the_chunked_wrapper_compresses_as_the_dense_sums(which, gathered):
    """The chunked wrapper's compressed sums = the one-block compressed sums
    = JAX's chunked wrapper's, and no launch is counted."""
    rng = np.random.default_rng(7)
    u = (0.5 * rng.standard_normal((16, D))).astype(np.float32)
    _, tfn, jfn = _compressors(D)[which]
    before = ops.dp_aggregate_sums.launches
    if gathered:
        slots = torch.tensor([3, 0, 9, 12, 5, 0, 0, 0], dtype=torch.int64)
        slot_mask = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
        got = ops.dp_aggregate_sums_chunked(torch.tensor(u), 0.3, chunk_m=3, slots=slots,
                                            slot_mask=slot_mask, compress_fn=tfn)
        rows = torch.tensor(u)[slots[:5]]
        want = tagg.partial_clip_moments(rows, 0.3, compress_fn=tfn)
        close_vec(got[0].numpy(), want.sum_c.numpy())
        close(got[2], want.sum_sq_clipped)
    else:
        got = ops.dp_aggregate_sums_chunked(torch.tensor(u), 0.3, chunk_m=4, compress_fn=tfn)
        js = jops.dp_aggregate_sums_chunked(jnp.asarray(u), 0.3, chunk_m=4, compress_fn=jfn)
        want = tagg.partial_clip_moments(torch.tensor(u), 0.3, compress_fn=tfn)
        for g, j in zip(got, js):
            close_vec(g.numpy(), np.asarray(j))
        close_vec(got[0].numpy(), want.sum_c.numpy())
        close(got[1], want.sum_sq)
        ragged = ops.dp_aggregate_sums_chunked(torch.tensor(u), 0.3, chunk_m=5, compress_fn=tfn)
        close_vec(ragged[0].numpy(), want.sum_c.numpy())
    assert ops.dp_aggregate_sums.launches == before


# ---------------------------------------------------------------------------
# The composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["randk", "sketch"])
@pytest.mark.parametrize("name", sorted(COMPRESS_OK))
def test_local_moments_scalar_sums_equal_the_dense_ones_and_jax(name, agg):
    """The compressed sums carry a (kc,) sum_c and the dense scalar sums
    (and extras); sum_c equals JAX's on its plan."""
    key = jax.random.PRNGKey(5)
    deltas = np.asarray(0.3 * jax.random.normal(key, (M, D)))
    mask = np.ones(M, np.float32)
    mask[::5] = 0.0
    w = torch.zeros(D)
    jalg, talg, tdense = jcompressed(name, agg), tcompressed(name, agg), tcompressed(name, None)
    noise = round_noise_of(jalg, key, M, D)
    mom_c, ex_c = talg.local_moments(noise, w, torch.tensor(deltas), torch.tensor(mask), 0,
                                     talg.init_state(w), binary_mask=True)
    mom_d, ex_d = tdense.local_moments(noise, w, torch.tensor(deltas), torch.tensor(mask), 0,
                                       tdense.init_state(w), binary_mask=True)
    assert mom_c.sum_c.shape == (talg.aggregation.comm_floats(D),)
    for f in ("sum_sq", "sum_sq_clipped", "count"):
        close(getattr(mom_c, f), getattr(mom_d, f), what=f)
    assert set(ex_c) == set(ex_d)
    for k in ex_d:
        close(ex_c[k], ex_d[k], what=k)
    jw = jnp.zeros(D)
    jmom, _ = jalg.local_moments(key, jw, jnp.asarray(deltas), jnp.asarray(mask), 0,
                                 jalg.init_state(jw))
    close_vec(mom_c.sum_c.numpy(), jmom.sum_c)


@pytest.mark.parametrize("agg", ["randk", "sketch", "sketch-ef"])
@pytest.mark.parametrize("name", sorted(COMPRESS_OK))
def test_comm_floats_and_names_equal_jax(name, agg):
    jalg, talg = jcompressed(name, agg), tcompressed(name, agg)
    assert talg.name == jalg.name
    assert talg.comm_floats(D) == jalg.comm_floats(D)
    assert tcompressed(name, None).comm_floats(D) == jalg_dense_floats(name)


def jalg_dense_floats(name):
    return jax_make(name, **COMPRESS_OK[name]).comm_floats(D)


def test_every_composed_name_counts_its_floats_as_jax():
    """The communication model of the dense compositions too: PrivUnit's
    s_hat sum, per-client sigmas, the clip-bit count, a weighted count."""
    from test_torch_moments import COMPOSED, algo_kwargs
    for name in COMPOSED:
        kw = algo_kwargs(name, m=M, d=D)
        assert make_algorithm(name, **kw).comm_floats(D) == jax_make(name, **kw).comm_floats(D), \
            name


def test_with_compression_names():
    assert tcompressed("cdp-fedexp", "randk").name == f"cdp-fedexp+randk{K}"
    alg = tcomp.with_compression(make_algorithm("fedavg"), tcomp.CountSketchAggregation(
        width=WIDTH, depth=DEPTH, top_k=4, error_feedback=True))
    assert alg.name == f"fedavg+sketch{WIDTH}x{DEPTH}-top4-ef"
    assert tcomp.RandKAggregation(k=10 * D).comm_floats(D) == D


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["randk", "sketch"])
@pytest.mark.parametrize("name", sorted(LDP_NAMES))
def test_ldp_names_refuse_compression(name, agg):
    with pytest.raises(ValueError, match="LDP mechanism releases a full"):
        tcomp.with_compression(make_algorithm(name, **LDP_NAMES[name]), AGGS[agg](tcomp))
    with pytest.raises(ValueError, match="LDP mechanism releases a full"):
        jcomp.with_compression(jax_make(name, **LDP_NAMES[name]), AGGS[agg](jcomp))


def test_weighted_and_scaffold_and_bad_layers_are_refused():
    alg = tcomp.compose_algorithm(tcomp.GaussianLDP(0.3, 0.21), tcomp.FedEXPStep(),
                                  tcomp.WeightedAggregation(weights=tuple([1.0] * M)))
    with pytest.raises(ValueError, match="weighted aggregation"):
        tcomp.with_compression(alg, tcomp.RandKAggregation(k=K))
    perclient = make_algorithm("ldp-fedexp-perclient", clip_norm=1.0, epsilons=(1.0,) * M,
                               delta=1e-5)
    with pytest.raises(ValueError, match="weighted aggregation"):
        tcomp.with_compression(perclient, tcomp.RandKAggregation(k=K))
    scaffold = make_algorithm("dp-scaffold", clip_norm=1.0, sigma=0.5, central=True,
                              num_clients=M, tau=TAU, eta_l=ETA_L)
    with pytest.raises(TypeError, match="needs a ComposedAlgorithm"):
        tcomp.with_compression(scaffold, tcomp.RandKAggregation(k=K))
    with pytest.raises(ValueError, match="error_feedback without top_k"):
        tcomp.CountSketchAggregation(width=WIDTH, error_feedback=True)
    for bad in (dict(k=0), dict(k=2.0), dict(k=True)):
        with pytest.raises(ValueError, match="positive int"):
            tcomp.RandKAggregation(**bad)
    with pytest.raises(ValueError, match="positive int"):
        tcomp.CountSketchAggregation(width=4, depth=0)


def test_per_row_noise_with_compress_fn_is_refused():
    u = torch.randn(8, D)
    fn = _compressors(D)[0][1]
    with pytest.raises(ValueError, match="compress_fn cannot combine"):
        tagg.partial_clip_moments(u, 0.3, torch.zeros(8, D), compress_fn=fn)
    with pytest.raises(ValueError, match="compress_fn cannot combine"):
        tagg.partial_clip_moments(u, 0.3, noise_seed=3, noise_sigma=0.5, compress_fn=fn)
    with pytest.raises(ValueError, match="compress_fn cannot combine"):
        tagg.fused_clip_aggregate(u, 0.3, noise_seed=3, noise_sigma=0.5, compress_fn=fn)
    with pytest.raises(ValueError, match="LDP noise"):
        ops.dp_aggregate_sums_chunked(u, 0.3, torch.zeros(8, D), chunk_m=4, compress_fn=fn)
    with pytest.raises(ValueError, match="LDP noise"):
        ops.dp_aggregate_sums_chunked(u, 0.3, chunk_m=4, noise_seed=1, noise_sigma=0.5,
                                      compress_fn=fn)


def test_a_round_without_a_plan_is_refused():
    alg = tcompressed("fedavg", "randk")
    w = torch.zeros(D)
    with pytest.raises(ValueError, match="holds none"):
        alg.apply_round_stateful(None, w, torch.randn(M, D), (), noise=tcomp.RoundNoise())


# ---------------------------------------------------------------------------
# The round's draws
# ---------------------------------------------------------------------------

def test_the_plan_has_a_generator_of_its_own():
    """The plan comes from (round seed, COMPRESS_TAG): the round generator's
    own draws are the dense composition's, and a lossless rand-k draws
    exactly the dense round's noise."""
    dense = tcompressed("cdp-fedexp", None)
    lossless = tcomp.with_compression(dense, tcomp.RandKAggregation(k=D))
    a = dense.draw_noise(round_generator(SEED, 2), M, D, "cpu")
    b = lossless.draw_noise(round_generator(SEED, 2), M, D, "cpu")
    assert torch.equal(a.central, b.central) and torch.equal(a.xi, b.xi)
    assert torch.equal(b.plan, torch.arange(D))
    sk = tcompressed("cdp-fedexp", "sketch")
    n1, n2 = (sk.draw_noise(round_generator(SEED, t), M, D, "cpu") for t in (2, 3))
    again = sk.draw_noise(round_generator(SEED, 2), M, D, "cpu")
    assert n1.central.shape == (WIDTH * DEPTH,)
    assert all(torch.equal(x, y) for x, y in zip(n1.plan, again.plan))
    assert not torch.equal(n1.plan.h, n2.plan.h)
    gen = round_generator(SEED, 2)
    want = tcz.sketch_plan(tcz.plan_generator(gen.initial_seed()), D, WIDTH, DEPTH)
    assert all(torch.equal(x, y) for x, y in zip(n1.plan, want))


# ---------------------------------------------------------------------------
# One round against JAX's _round_step
# ---------------------------------------------------------------------------

class Replay(tcomp.ComposedAlgorithm):
    """A composition whose round t draws a given ``RoundNoise`` (JAX's)."""

    def __init__(self, alg, noises):
        super().__init__(alg.mechanism, alg.step, alg.aggregation, alg.name)
        object.__setattr__(self, "noises", noises)

    def draw_noise(self, gen, m, d, device, t=None):
        return self.noises[t]


@dataclasses.dataclass(frozen=True)
class ReplayCohort(CohortSpec):
    """A cohort whose round masks are given (JAX's), found by the round's seed."""

    masks: tuple = ()
    seeds: tuple = ()

    def round_mask(self, gen, num_clients):
        return self.masks[self.seeds.index(gen.initial_seed())]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("agg", ["randk", "sketch"])
@pytest.mark.parametrize("name", FAST_PARITY)
def test_one_round_matches_jax_round_step(name, agg, engine, data):
    jalg, talg = jcompressed(name, agg), tcompressed(name, agg)
    rng = np.random.default_rng(31)
    w = (0.3 * rng.standard_normal(D)).astype(np.float32)
    t, key = 2, jax.random.PRNGKey(60)
    tkw, jkw = ENGINES[engine]
    jcoh = jkw.get("cohort")
    step = _round_step(jalg, jlocal.build_cohort_local_fn(jax_loss, None, TAU), None, 1,
                       cohort=jcoh, tau=TAU)
    jw, _, jouts = step(jnp.asarray(w), jalg.init_state(jnp.asarray(w)), key, t, jbatches(data),
                        ETA_L)
    noise = round_noise_of(jalg, key, M, D, t)
    tw0 = torch.tensor(w)
    if engine == "eager":
        deltas = cohort_updates(linreg_loss, tw0, tbatches(data), TAU, ETA_L)
        tw, aux, _ = talg.apply_round_stateful(None, tw0, deltas, (), noise, t)
    elif engine == "stream":
        gen = round_generator(SEED, t)
        tstep = srv.stream_round_step(
            Replay(talg, {t: noise}),
            lambda w_, b, eta: cohort_updates(linreg_loss, w_, b, TAU, eta), None,
            chunk_clients=CHUNK, num_clients=M)
        tw, _, outs = tstep(tw0, (), gen, t, tbatches(data), ETA_L)
        aux = tcomp.RoundAux(eta_g=outs[0])
    else:
        mask = torch.tensor(np.asarray(jcoh.round_mask(key, M)))
        local_fn = lambda w_, b, eta: cohort_updates(linreg_loss, w_, b, TAU, eta)  # noqa: E731
        inp = srv.stage_inputs(talg, local_fn, noise, t, M, "cpu", cohort=tkw["cohort"],
                               mask=mask)
        tw, aux, _ = srv.masked_round(talg, local_fn, tw0, (), inp, tkw["cohort"], t,
                                      tbatches(data), ETA_L)
    close(aux.eta_g, jouts[0], what="eta_g")
    close_vec(tw.numpy(), jw)


# ---------------------------------------------------------------------------
# 4-round sessions against JAX's
# ---------------------------------------------------------------------------

def tsession(data, alg, rounds=ROUNDS, **kw):
    return FederatedSession(alg, linreg_loss, np.zeros(D, np.float32), dict(data),
                            train=TrainSpec(rounds=rounds, tau=TAU, eta_l=ETA_L), device="cpu",
                            **kw)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("agg", ["randk", "sketch"])
@pytest.mark.parametrize("name", FAST_PARITY)
def test_sessions_match_jax(name, agg, engine, data):
    jalg, talg = jcompressed(name, agg), tcompressed(name, agg)
    tkw, jkw = ENGINES[engine]
    key = jax.random.PRNGKey(SEED)
    want = JaxSession(jalg, jax_loss, jnp.zeros(D), jbatches(data),
                      train=JaxTrain(rounds=ROUNDS, tau=TAU, eta_l=ETA_L), **jkw).run(key)
    keys = [jax.random.fold_in(key, t) for t in range(ROUNDS)]
    noises = {t: round_noise_of(jalg, keys[t], M, D, t) for t in range(ROUNDS)}
    if "cohort" in tkw:
        c = tkw["cohort"]
        tkw = {**tkw, "cohort": ReplayCohort(
            q=c.q, gather=c.gather,
            masks=tuple(torch.tensor(np.asarray(jkw["cohort"].round_mask(k, M))) for k in keys),
            seeds=tuple(round_generator(SEED, t).initial_seed() for t in range(ROUNDS)))}
    got = tsession(data, Replay(talg, noises), **tkw).run(SEED)
    runs_close(got, want)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fedavg", "fedexp", "cdp-fedexp"])
def test_lossless_randk_is_the_dense_run(name, data):
    dense = tsession(data, tcompressed(name, None)).run(SEED)
    lossless = tsession(data, tcomp.with_compression(tcompressed(name, None),
                                                     tcomp.RandKAggregation(k=D))).run(SEED)
    runs_close(lossless, dense)


@pytest.mark.parametrize("agg", ["randk", "sketch", "sketch-ef"])
@pytest.mark.parametrize("name", sorted(COMPRESS_OK))
def test_stream_equals_eager_and_gathered_equals_dense(name, agg, data):
    alg = tcompressed(name, agg)
    eager = tsession(data, alg).run(SEED)
    runs_close(tsession(data, alg, **ENGINES["stream"][0]).run(SEED), eager)
    dense = tsession(data, alg, cohort=CohortSpec(q=0.5)).run(SEED)
    runs_close(tsession(data, alg, cohort=CohortSpec(q=0.5, gather=True)).run(SEED), dense)
    assert torch.isfinite(eager.final_w).all() and torch.isfinite(dense.final_w).all()
    if name in ("fedavg", "cdp-fedexp"):
        fixed = tsession(data, alg, cohort=CohortSpec(size=12)).run(SEED)
        runs_close(tsession(data, alg, cohort=CohortSpec(size=12), **ENGINES["stream"][0]
                            ).run(SEED), fixed)


def test_the_ef_carry_over_four_rounds_matches_jax(data):
    """fedavg under the top-k sketch with error feedback: each round's model
    and residual against JAX's _round_step fed the same carry."""
    jalg, talg = jcompressed("fedavg", "sketch-ef"), tcompressed("fedavg", "sketch-ef")
    jstate = jalg.init_state(jnp.zeros(D))
    tstate = talg.init_state(torch.zeros(D))
    assert isinstance(jstate, jcomp.CompressionCarry)
    assert isinstance(tstate, tcomp.CompressionCarry) and torch.equal(tstate.ef, torch.zeros(D))
    step = _round_step(jalg, jlocal.build_cohort_local_fn(jax_loss, None, TAU), None, 1, tau=TAU)
    jw, tw = jnp.zeros(D), torch.zeros(D)
    key = jax.random.PRNGKey(2)
    for t in range(4):
        k = jax.random.fold_in(key, t)
        jw, jstate, _ = step(jw, jstate, k, t, jbatches(data), ETA_L)
        deltas = cohort_updates(linreg_loss, tw, tbatches(data), TAU, ETA_L)
        tw, _, tstate = talg.apply_round_stateful(None, tw, deltas, tstate,
                                                  round_noise_of(jalg, k, M, D, t), t)
        close_vec(tw.numpy(), jw)
        close_vec(tstate.ef.numpy(), jstate.ef)
        assert int((tw != 0).sum()) <= (t + 1) * (D // 2)
    assert float(torch.linalg.vector_norm(tstate.ef)) > 0


def test_a_faulted_compressed_round_matches_jax(data):
    kw = dict(dropout=0.3, straggler=0.2, straggler_steps=1, corrupt=0.1)
    jalg, talg = jcompressed("cdp-fedexp", "sketch"), tcompressed("cdp-fedexp", "sketch")
    key, t = jax.random.PRNGKey(61), 1
    w = np.full(D, 0.1, np.float32)
    local_j = jlocal.build_cohort_local_fn(jax_loss, None, TAU, with_steps=True)
    step = _round_step(jalg, local_j, None, 1, fault=JaxFault(**kw), tau=TAU)
    jw, _, jouts = step(jnp.asarray(w), (), key, t, jbatches(data), ETA_L)
    faults = tuple(torch.tensor(np.asarray(v))
                   for v in jfaults.fault_masks(JaxFault(**kw), key, M))
    assert float(faults[2].sum()) > 0     # a NaN row reaches the round

    def local_fn(w_, b, eta, steps=None):
        return cohort_updates(linreg_loss, w_, b, TAU, eta, steps=steps)

    fault = FaultSpec(**kw)
    inp = srv.stage_inputs(talg, local_fn, round_noise_of(jalg, key, M, D, t), t, M, "cpu",
                           fault=fault, mask=torch.ones(M), faults=faults)
    tw, aux, _ = srv.masked_round(talg, local_fn, torch.tensor(w), (), inp, None, t,
                                  tbatches(data), ETA_L, fault=fault, tau=TAU)
    close(aux.eta_g, jouts[0], what="eta_g")
    close_vec(tw.numpy(), jw)


def test_run_batched_resume_and_rollback_keep_the_ef_residual_in_bits(data, tmp_path):
    alg = tcompressed("cdp-fedexp", "sketch-ef")
    want = tsession(data, alg, rounds=6).run(3)
    batched = tsession(data, alg, rounds=6).run_batched([3, 4])
    for f in RESULT:
        assert same(getattr(batched, f)[0], getattr(want, f)), f
    assert same_run(tsession(data, alg, rounds=6, **ENGINES["stream"][0]).run_batched([3]),
                    tsession(data, alg, rounds=6, **ENGINES["stream"][0]).run_batched([3]))
    tsession(data, alg, rounds=3).run(3, checkpoint_dir=str(tmp_path / "a"))
    files = sorted(np.load(tmp_path / "a" / "ckpt_00000003.npz").files)
    assert "carry/1/ef" in files and not any(f.startswith("carry/1/inner") for f in files)
    assert same_run(tsession(data, alg, rounds=6).resume(str(tmp_path / "a")), want)
    # the watchdog rolls a planted divergence back to the checkpoint at round
    # 2, whose residual is restored: the recovered run is the unkilled one
    spec = FaultSpec(watchdog=True)
    clean = tsession(data, alg, rounds=6, fault=spec).run(3)
    assert same_run(clean, want)
    s = tsession(data, alg, rounds=6, fault=spec)
    calls = []

    def poison_round_3(carry, attempt):
        calls.append(attempt)
        return carry

    inner_step = s._step

    def step_with_poison():
        step = inner_step()

        def poisoned(w, state, gen, t, batches, eta_l):
            w_next, state_next, out = step(w, state, gen, t, batches, eta_l)
            if t == 3 and len(calls) == 1:
                w_next = torch.full_like(w_next, float("inf"))
            return w_next, state_next, out
        return poisoned

    s._step = step_with_poison
    s._inject_divergence = poison_round_3
    got = s.run(3, checkpoint_dir=str(tmp_path / "b"), checkpoint_every=2,
                on_divergence=RecoveryPolicy(max_retries=2))
    assert calls == [0, 1] and got.fault_round is None and s._rounds_retried == 2
    assert same_run(got, want)
    adam = tcompressed("dp-fedadam-cdp", "sketch-ef")
    tsession(data, adam, rounds=2).run(1, checkpoint_dir=str(tmp_path / "c"))
    files = sorted(np.load(tmp_path / "c" / "ckpt_00000002.npz").files)
    assert "carry/1/ef" in files and any(f.startswith("carry/1/inner/") for f in files)
    assert same_run(tsession(data, adam, rounds=4).resume(str(tmp_path / "c")),
                    tsession(data, adam, rounds=4).run(1))
    assert ckpt.latest_step(str(tmp_path / "c")) == 4


def test_local_spec_trainers_take_compression(data):
    """A minibatch trainer on per-sample data: gathered = dense under rand-k."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, 8, D)).astype(np.float32)
    y = rng.standard_normal((M, 8)).astype(np.float32)
    alg = tcompressed("cdp-fedexp", "randk")

    def run(**kw):
        return FederatedSession(alg, lambda w, b: torch.mean((b["x"] @ w - b["y"]) ** 2),
                                np.zeros(D, np.float32), {"x": x, "y": y},
                                train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                                local=LocalSpec(batch_size=4, epochs=2), device="cpu",
                                **kw).run(1)

    dense = run(cohort=CohortSpec(q=0.5))
    runs_close(run(cohort=CohortSpec(q=0.5, gather=True)), dense)
    assert torch.isfinite(dense.final_w).all()
