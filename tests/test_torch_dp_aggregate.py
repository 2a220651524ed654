"""The port's dp_aggregate (plain version on the CPU) against the JAX package's.

Inputs are made with numpy from fixed seeds and handed to both packages; JAX
runs its Pallas kernel in interpret mode, as its own tests do.  Tolerances:
rtol 1e-5 on every output, with atol 1e-5 on the (d,) sum, whose entries can
cancel to near zero (the JAX package's own kernel tests use the same pair).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dp_aggregate import kernel as jax_kernel  # noqa: E402
from repro.kernels.dp_aggregate import ops as jax_ops  # noqa: E402
from repro.kernels.dp_aggregate import ref as jax_ref  # noqa: E402
from repro_torch.core.aggregation import fused_clip_aggregate, resolve_backend  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops, ref  # noqa: E402

RAGGED = [(37, 129), (24, 300), (10, 64), (1, 5)]


def _inputs(m, d, seed=0):
    rng = np.random.default_rng(seed)
    u = (2.0 * rng.standard_normal((m, d))).astype(np.float32)
    noise = (0.5 * rng.standard_normal((m, d))).astype(np.float32)
    return u, noise


def _assert_stats(got, want, m=None):
    np.testing.assert_allclose(got.cbar.numpy(), np.asarray(want.cbar), rtol=1e-5, atol=1e-5)
    for f in ("mean_sq", "agg_sq", "mean_sq_clipped"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)


class TestPlainAgainstJax:
    @pytest.mark.parametrize("m,d", RAGGED)
    @pytest.mark.parametrize("mode", ["none", "operand"])
    def test_dp_aggregate_matches_pallas_interpret(self, m, d, mode):
        u, noise = _inputs(m, d, seed=m * d)
        noise = noise if mode == "operand" else None
        want = jax_ops.dp_aggregate(jnp.asarray(u), 1.0,
                                    None if noise is None else jnp.asarray(noise),
                                    interpret=True)
        got = ops.dp_aggregate(torch.tensor(u), 1.0,
                               None if noise is None else torch.tensor(noise))
        _assert_stats(got, want)

    @pytest.mark.parametrize("m,d", RAGGED[::2])
    @pytest.mark.parametrize("clip", [0.1, 1e9])
    def test_ref_sums_match_jax_ref(self, m, d, clip):
        u, noise = _inputs(m, d, seed=7)
        want = jax_ref.dp_aggregate_ref(jnp.asarray(u), jnp.asarray(noise), clip)
        got = ref.dp_aggregate_ref(torch.tensor(u), torch.tensor(noise), clip)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)

    @pytest.mark.parametrize("m,d", [(37, 129), (40, 192)])
    def test_fused_equals_jax_operand_fed_port_noise(self, m, d):
        """Plain fused mode == JAX's operand mode fed the port's own noise."""
        u, _ = _inputs(m, d, seed=3)
        seed, sigma = 0xC0FFEE, 1.3
        port_noise = ops.generate_ldp_noise(m, d, seed, sigma, device="cpu")
        want = jax_ops.dp_aggregate(jnp.asarray(u), 0.5, jnp.asarray(port_noise.numpy()),
                                    interpret=True)
        got = ops.dp_aggregate(torch.tensor(u), 0.5, noise_seed=seed, noise_sigma=sigma)
        _assert_stats(got, want)

    def test_threefry_bits_equal_the_pallas_kernels_prf(self):
        rng = np.random.default_rng(11)
        x0 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
        x1 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
        for k0 in (0, 1, 0x5EED, 2**32 - 1):
            j0, j1 = jax_kernel._threefry2x32(
                jnp.uint32(k0), jnp.uint32(0x9E3779B9),
                jnp.asarray(x0.astype(np.uint32)), jnp.asarray(x1.astype(np.uint32)))
            t0, t1 = ref.threefry2x32(k0, 0x9E3779B9, torch.tensor(x0.astype(np.int64)),
                                      torch.tensor(x1.astype(np.int64)))
            np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
            np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


class TestPlainNoise:
    SIGMA = 1.3

    def test_moments(self):
        """Mean, variance, kurtosis and neighbour correlations of N(0, sigma^2);
        the two normals of one Threefry call (columns 2k, 2k + 1) and their
        squares uncorrelated."""
        m, d = 512, 256
        z = ops.generate_ldp_noise(m, d, 123, self.SIGMA, device="cpu").double().numpy()
        n = z.size
        assert abs(z.mean()) < 5 * self.SIGMA / np.sqrt(n)
        np.testing.assert_allclose(z.std(), self.SIGMA, rtol=0.02)
        np.testing.assert_allclose((z**4).mean(), 3 * self.SIGMA**4, rtol=0.1)
        for a, b in ((z[:, :-1], z[:, 1:]), (z[:-1], z[1:]), (z[:, 0::2], z[:, 1::2])):
            assert abs(np.mean(a * b) / self.SIGMA**2) < 5 / np.sqrt(a.size)
        cos, sin = z[:, 0::2].ravel() ** 2, z[:, 1::2].ravel() ** 2
        assert abs(np.corrcoef(cos, sin)[0, 1]) < 5 / np.sqrt(cos.size)

    @pytest.mark.parametrize("m,d,row_start", [(7, 33, 0), (5, 64, 0), (6, 31, 1000)])
    def test_noise_is_box_muller_on_the_pallas_kernels_threefry_bits(self, m, d, row_start):
        """Row r, pair k: (b0, b1) = threefry2x32((seed, golden), (r, k)) from
        the JAX package; Box-Muller in numpy float32; z[:, 2k] the cosine,
        z[:, 2k + 1] the sine, the last sine dropped at odd d."""
        seed, sigma = 0x5EED, 1.3
        pairs = (d + 1) // 2
        rows = np.arange(row_start, row_start + m, dtype=np.uint32)
        x0 = np.broadcast_to(rows[:, None], (m, pairs))
        x1 = np.broadcast_to(np.arange(pairs, dtype=np.uint32)[None, :], (m, pairs))
        b0, b1 = (np.asarray(b) for b in jax_kernel._threefry2x32(
            jnp.uint32(seed), jnp.uint32(0x9E3779B9), jnp.asarray(x0), jnp.asarray(x1)))

        def unit(b):
            return ((b >> 8).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-24)

        rho = np.sqrt(np.float32(-2.0) * np.log(unit(b0)))
        theta = np.float32(2.0 * np.pi) * unit(b1)
        z = np.stack((rho * np.cos(theta), rho * np.sin(theta)), axis=-1).reshape(m, 2 * pairs)
        want = np.float32(sigma) * z[:, :d]
        got = ref.ldp_noise_ref(m, d, seed, sigma, row_start=row_start).numpy()
        assert got.dtype == np.float32 and got.shape == (m, d)
        # float32 rounding: the two libraries' log, cos and sin differ by an ulp or two
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * sigma)

    @pytest.mark.parametrize("narrow", [1, 2, 33, 50, 95, 96])
    def test_a_narrower_draw_is_the_prefix_of_a_wider_one_at_odd_d(self, narrow):
        wide = ops.generate_ldp_noise(9, 97, 31, 0.9, device="cpu", row_start=4)
        part = ops.generate_ldp_noise(9, narrow, 31, 0.9, device="cpu", row_start=4)
        assert torch.equal(part, wide[:, :narrow])

    def test_deterministic_and_seed_dependent(self):
        a = ops.generate_ldp_noise(32, 128, 1, 1.0, device="cpu")
        b = ops.generate_ldp_noise(32, 128, 1, 1.0, device="cpu")
        c = ops.generate_ldp_noise(32, 128, 2, 1.0, device="cpu")
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)

    @pytest.mark.parametrize("start,stop", [(0, 7), (5, 40), (39, 40)])
    def test_row_start_and_slicing_leave_the_noise_unchanged(self, start, stop):
        full = ops.generate_ldp_noise(40, 96, 77, 0.7, device="cpu")
        part = ops.generate_ldp_noise(stop - start, 96, 77, 0.7, device="cpu", row_start=start)
        assert torch.equal(part, full[start:stop])
        narrow = ops.generate_ldp_noise(40, 33, 77, 0.7, device="cpu")
        assert torch.equal(narrow, full[:, :33])

    def test_fused_sums_under_row_offsets_add_up(self):
        """Two halves of a cohort, each keyed by its global rows, sum to the whole."""
        u, _ = _inputs(30, 50, seed=5)
        u = torch.tensor(u)
        whole = ops.dp_aggregate_sums(u, 1.0, noise_seed=9, noise_sigma=0.4)
        lo = ops.dp_aggregate_sums(u[:13], 1.0, noise_seed=9, noise_sigma=0.4)
        hi = ops.dp_aggregate_sums(u[13:], 1.0, noise_seed=9, noise_sigma=0.4, row_start=13)
        for w, a, b in zip(whole, lo, hi):
            np.testing.assert_allclose((a + b).numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def _emulate_plan(u, noise, clip, plan):
    """The kernel's partition and reduction order, in float64 numpy: cluster c
    sums its rows, block b of it the window [b W, (b + 1) W); a row's norm is
    the sum of its blocks' window norms in rank order."""
    m, d = u.shape
    colpart = np.zeros((plan.clusters, d))
    clip_sq = np.zeros(plan.clusters)
    seen = np.zeros((m, d), dtype=int)
    for c in range(plan.clusters):
        for row in range(c * plan.rows_per_cluster, min(m, (c + 1) * plan.rows_per_cluster)):
            windows = [slice(b * plan.window, min(d, (b + 1) * plan.window))
                       for b in range(plan.cluster)]
            norm = sum(float(np.sum(u[row, w] ** 2)) for w in windows)
            scale = min(1.0, clip / np.sqrt(max(norm, 1e-12)))
            clip_sq[c] += norm * scale**2
            for w in windows:
                colpart[c, w] += u[row, w] * scale + noise[row, w]
                seen[row, w] += 1
    return colpart.sum(axis=0), clip_sq.sum(), seen


class TestLaunchPlan:
    """The aggregation launch's shape (ops._launch_plan), computed on the host."""

    @pytest.mark.parametrize("d", [1, 100, 500, 4099, 131072, 300001])
    @pytest.mark.parametrize("m", [1, 37, 1000])
    def test_plan_fits_the_card_and_covers_every_column_once(self, m, d):
        plan = ops._launch_plan(m, d)
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.window % 4 == 0
        assert plan.smem_bytes + 2304 <= 232448     # with the kernel's static shared memory
        assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
        cover = np.zeros(d + plan.cluster * plan.window, dtype=int)
        for b in range(plan.cluster):
            cover[b * plan.window:min(d, (b + 1) * plan.window)] += 1
        assert (cover[:d] == 1).all() and not cover[d:].any()
        assert (plan.cluster - 1) * plan.window < d          # no block without columns
        rows = plan.clusters * plan.rows_per_cluster
        assert rows >= m and rows - plan.rows_per_cluster < m   # no cluster without rows
        assert plan.cluster * plan.clusters <= 132             # one block per SM
        if plan.pairs:   # the ring path: the window in registers, two stages or more
            assert 2 * plan.pairs * plan.threads >= plan.window
            assert plan.stages >= 2 and plan.slot_floats >= plan.window + 8
            assert plan.smem_bytes == 4 * plan.slot_floats * plan.stages
        else:            # the L2 path: rows and column sums in flight stay in 24 MiB
            assert plan.window > 16384 and plan.smem_bytes == 0
            assert 8 * d * plan.clusters <= 24 << 20 or plan.clusters == 1

    def test_plans_at_the_main_paths_shapes(self):
        full = ops._launch_plan(1000, 131072, max_clusters=16)
        assert (full.cluster, full.window, full.threads, full.pairs, full.stages) == \
            (8, 16384, 512, 16, 3)
        assert (full.clusters, full.rows_per_cluster) == (16, 63)
        for d in (100, 500):   # the paper's widths: one-block clusters, one per SM
            paper = ops._launch_plan(1000, d)
            assert paper.cluster == 1 and paper.pairs == 1 and paper.clusters == 125
        assert ops._launch_plan(8, 300001).pairs == 0       # the L2 path
        assert ops._launch_plan(1000, 131072, sms=66, max_clusters=4).clusters == 4

    @pytest.mark.parametrize("m,d", [(37, 129), (50, 4099), (9, 40000), (3, 131073)])
    def test_the_plans_partition_reduces_to_the_plain_sums(self, m, d):
        u, noise = _inputs(m, d, seed=d)
        plan = ops._launch_plan(m, d)
        total, clip_sq, seen = _emulate_plan(u.astype(np.float64), noise.astype(np.float64),
                                             1.0, plan)
        assert (seen == 1).all()
        want = ref.dp_aggregate_ref(torch.tensor(u), torch.tensor(noise), 1.0)
        np.testing.assert_allclose(total, want[0].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(clip_sq, float(want[2]), rtol=1e-5)


class TestBackendsAndGuards:
    def test_resolve_backend_by_device(self):
        assert resolve_backend("auto", "cuda") == "kernel"
        assert resolve_backend("auto", torch.device("cuda", 0), wants_noise_gen=True) \
            == "kernel-fused"
        assert resolve_backend(None, "cpu") == "torch"
        assert resolve_backend("auto", "cpu", wants_noise_gen=True) == "torch"
        assert resolve_backend("kernel", "cpu") == "kernel"
        with pytest.raises(ValueError, match="unknown aggregation backend"):
            resolve_backend("jnp", "cpu")

    @pytest.mark.parametrize("backend", ["auto", "torch", "kernel", "kernel-fused"])
    def test_every_backend_computes_the_same_on_cpu(self, backend):
        u, _ = _inputs(20, 70, seed=2)
        u = torch.tensor(u)
        want = fused_clip_aggregate(u, 0.8, noise_seed=3, noise_sigma=0.5, backend="torch")
        got = fused_clip_aggregate(u, 0.8, noise_seed=3, noise_sigma=0.5, backend=backend)
        for f in ("cbar", "mean_sq", "agg_sq", "mean_sq_clipped"):
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                       rtol=1e-6, atol=1e-7)

    def test_cpu_path_leaves_the_launch_counters_at_zero(self):
        u = torch.tensor(_inputs(16, 40)[0])
        fused_clip_aggregate(u, 1.0, backend="kernel")
        fused_clip_aggregate(u, 1.0, noise_seed=1, noise_sigma=0.3, backend="kernel")
        fused_clip_aggregate(u, 1.0, noise_seed=1, noise_sigma=0.3, backend="kernel-fused")
        assert ops.dp_aggregate_sums.launches == 0
        assert ops.generate_ldp_noise.launches == 0

    def test_guards(self):
        u = torch.zeros(4, 8)
        with pytest.raises(ValueError, match="requires `noise_sigma`"):
            fused_clip_aggregate(u, 1.0, noise_seed=1)
        with pytest.raises(ValueError, match="not both"):
            fused_clip_aggregate(u, 1.0, torch.zeros(4, 8), noise_seed=1, noise_sigma=1.0)
        with pytest.raises(ValueError, match="requires `noise_sigma`"):
            ops.dp_aggregate_sums(u, 1.0, noise_seed=1)
        with pytest.raises(ValueError, match="shape"):
            ops.dp_aggregate_sums(u, 1.0, torch.zeros(4, 9))
        with pytest.raises(ValueError, match="32-bit"):
            ops.dp_aggregate_sums(u, 1.0, noise_seed=2**32, noise_sigma=1.0)

    def test_zero_rows_and_infinite_clip(self):
        u = torch.tensor(_inputs(6, 10)[0])
        u[2] = 0.0
        s, sq_rel, sq_clip = ops.dp_aggregate_sums(u, float("inf"))
        np.testing.assert_allclose(s.numpy(), u.sum(0).numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(sq_clip), float((u * u).sum()), rtol=1e-6)
        assert float(sq_rel) == float(sq_clip)
