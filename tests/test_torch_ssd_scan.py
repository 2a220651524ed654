"""The port's ssd_scan (its plain recurrence, on the CPU), the plain function
in its CUDA kernels' order (``ssd_scan_stages_ref``) and its chunked SSD
against the JAX package's: the Pallas kernel in interpret mode, its
recurrence ``ssd_scan_ref``, ``models.ssm.ssd_chunked`` and ``_final_state``.

Inputs are made with numpy from fixed seeds and handed to both packages.  The
shapes are those of ``tests/test_kernels.py::TestSSDScan`` (the JAX kernel at
its chunks of 16, 32 and 64, S = 100 on its pad path), plus a ragged S of 300
across several chunks, the strong-decay case, and inputs drawn as Mamba2
initialises them (A = -U(1, 16), dt log-uniform in [1e-3, 1e-1]), where the
state carries across many chunks.  Tolerances: the kernel's output at rtol
2e-4 and atol 2e-4, as the JAX package holds its kernel (the recurrence
against the chunked dual form: float32 exp(s_i - s_j) against products of
per-step decays); the strong-decay case at 1e-4, as there; the ports of
``ssd_chunked`` and ``_final_state`` at rtol 1e-5 and atol 1e-5 (the same
algorithm, float32 sums in other orders); the kernels' order against the
port's chunked SSD at that tolerance too.  The kernels' products on the tensor
cores (3xTF32) are emulated here and held to chip_smoke.SSD_RTOL against a
float64 recurrence; products in TF32 alone are shown to fall outside it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_stages_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {  # b, s, h, p, n, JAX kernel chunk, inputs
    "s64-chunk16": (1, 64, 2, 16, 8, 16, "test_kernels"),
    "s128-chunk32": (2, 128, 4, 32, 16, 32, "test_kernels"),
    "s100-pad": (1, 100, 2, 16, 8, 32, "test_kernels"),
    "s256-chunk64": (1, 256, 1, 64, 32, 64, "test_kernels"),
    "ragged-s300": (2, 300, 3, 16, 8, 64, "test_kernels"),
    "mamba2-ranges-s300": (2, 300, 4, 16, 32, 64, "mamba2"),
}


def _inputs(b, s, h, p, n, kind, seed):
    """x, dt, a, B, C as numpy float32, drawn as ``tests/test_kernels.py``
    draws them, or as Mamba2 initialises A and dt."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    if kind == "mamba2":
        rate, dt = chip_smoke.mamba2_a_dt(rng.random(h), rng.random((b, s, h)))
        a = -rate
    else:
        dt = 0.1 + 0.5 * rng.random((b, s, h))
        a = -np.exp(0.3 * rng.standard_normal(h))
    bm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    cm = rng.standard_normal((b, s, n)) / np.sqrt(n)
    return tuple(v.astype(np.float32) for v in (x, dt, a, bm, cm))


def _both(arrays):
    return [torch.tensor(v) for v in arrays], [jnp.asarray(v) for v in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_kernel_and_ref(case):
    b, s, h, p, n, chunk, kind = CASES[case]
    t, j = _both(_inputs(b, s, h, p, n, kind, seed=s + h))
    before = ops.ssd_scan.launches
    got = ssd_scan(*t)
    assert ops.ssd_scan.launches == before   # the CPU runs the plain version
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssd_scan(*j, chunk=chunk)),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssd_ref(*j)), **KERNEL_TOL)


def test_decay_state_carry():
    """The JAX package's strong-decay case: chunk boundaries must be seamless."""
    b, s, h, p, n = 1, 128, 1, 8, 4
    x = np.random.default_rng(12).standard_normal((b, s, h, p)).astype(np.float32)
    arrays = (x, np.full((b, s, h), 1.5, np.float32), np.array([-2.0], np.float32),
              np.ones((b, s, n), np.float32) / n, np.ones((b, s, n), np.float32))
    t, j = _both(arrays)
    got = ssd_scan(*t).numpy()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_ssd_scan(*j, chunk=16)), **tol)
    np.testing.assert_allclose(got, np.asarray(jax_ssd_ref(*j)), **tol)


@pytest.mark.parametrize("case", ["s100-pad", "ragged-s300", "mamba2-ranges-s300"])
def test_final_state_matches_jax(case):
    b, s, h, p, n, _, kind = CASES[case]
    t, j = _both(_inputs(b, s, h, p, n, kind, seed=3))
    want = np.asarray(jax_ssm._final_state(*j))
    y, state = ssd_scan(*t, return_state=True)
    assert state.shape == (b, h, n, p) and state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), want, **KERNEL_TOL)
    np.testing.assert_allclose(y.numpy(), ssd_scan(*t).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(ssm._final_state(*t[:4]).numpy(), want, **PORT_TOL)


@pytest.mark.parametrize("case", ["s128-chunk32", "s100-pad", "mamba2-ranges-s300"])
@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_chunked_matches_jax(case, chunk):
    b, s, h, p, n, _, kind = CASES[case]
    t, j = _both(_inputs(b, s, h, p, n, kind, seed=4))
    got = ssm.ssd_chunked(*t, chunk=chunk).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ssm.ssd_chunked(*j, chunk=chunk)), **PORT_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ssd_ref(*j)), **KERNEL_TOL)


def test_ref_matches_jax_ref():
    t, j = _both(_inputs(2, 70, 3, 8, 5, "mamba2", seed=5))
    np.testing.assert_allclose(ssd_scan_ref(*t).numpy(), np.asarray(jax_ssd_ref(*j)), **PORT_TOL)


def test_rejects_misshapen_inputs():
    t, _ = _both(_inputs(1, 10, 2, 4, 3, "test_kernels", seed=6))
    x, dt, a, bm, cm = t
    with pytest.raises(ValueError, match="want x"):
        ssd_scan(x[0], dt, a, bm, cm)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_scan(x, dt[:, :5], a, bm, cm)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_scan(x, dt, a, bm, cm[..., :2])
    with pytest.raises(TypeError, match="floating point"):
        ssd_scan(x, dt, a.long(), bm, cm)


@pytest.mark.parametrize("case", list(CASES))
def test_stages_ref_matches_jax_kernel_and_ref(case):
    """The plain function in the CUDA kernels' order (C B^T, chunk states,
    state passing, chunk outputs) at their chunk."""
    b, s, h, p, n, jax_chunk, kind = CASES[case]
    t, j = _both(_inputs(b, s, h, p, n, kind, seed=s + h))
    got, state = ssd_scan_stages_ref(*t, chunk=ops.CHUNK, return_state=True)
    assert got.shape == (b, s, h, p) and state.shape == (b, h, n, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssd_scan(*j, chunk=jax_chunk)),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssd_ref(*j)), **KERNEL_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jax_ssm._final_state(*j)),
                               **KERNEL_TOL)


@pytest.mark.parametrize("case", ["s100-pad", "ragged-s300", "mamba2-ranges-s300"])
def test_stages_ref_matches_port_chunked(case):
    b, s, h, p, n, _, kind = CASES[case]
    t, _ = _both(_inputs(b, s, h, p, n, kind, seed=7))
    got, state = ssd_scan_stages_ref(*t, chunk=ops.CHUNK, return_state=True)
    np.testing.assert_allclose(got.numpy(), ssm.ssd_chunked(*t, chunk=ops.CHUNK).numpy(),
                               **PORT_TOL)
    np.testing.assert_allclose(state.numpy(), ssm._final_state(*t[:4]).numpy(), **PORT_TOL)


def _tf32(t):
    """Round float32 to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, the low 13 bits of the significand dropped."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a, b):
    """A product as the CUDA kernels compute it on the tensor cores: each
    operand split into hi = tf32(v) and lo = tf32(v - hi), float32 sums of
    lo*hi, hi*lo and hi*hi (lo*lo dropped); products of TF32 values are
    exact in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _matmul_tf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _recurrence64(x, dt, a, bm, cm):
    """The step recurrence in float64: y and the final state."""
    x, dt, a, bm, cm = (torch.tensor(v, dtype=torch.float64) for v in (x, dt, a, bm, cm))
    bsz, s, h, p = x.shape
    state = torch.zeros(bsz, h, bm.shape[-1], p, dtype=torch.float64)
    y = torch.empty(bsz, s, h, p, dtype=torch.float64)
    for t in range(s):
        decay = torch.exp(a[None] * dt[:, t])
        state = decay[..., None, None] * state + bm[:, t, None, :, None] * (
            x[:, t] * dt[:, t, :, None])[:, :, None, :]
        y[:, t] = torch.einsum("bn,bhnp->bhp", cm[:, t], state)
    return y, state


def _worst(got, want):
    """The largest error against chip_smoke's check, |k - p| <= SSD_RTOL
    (|p| + max|p|), as a share of its bound."""
    got, want = got.double(), want.double()
    tol = chip_smoke.SSD_RTOL * (want.abs() + want.abs().max())
    return float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("products", ["3xtf32", "tf32"])
def test_tensor_core_products_against_ssd_rtol(products, capsys):
    """At a Mamba2-ranged shape and the kernels' chunk, the 3xTF32 products
    the CUDA kernels use keep y and the final state within chip_smoke.py's
    SSD_RTOL of a float64 recurrence; TF32 products alone do not, which is
    why the kernels never use them.  The reading is printed (run with -s)."""
    arrays = _inputs(1, 1024, 4, 64, 128, "mamba2", seed=11)
    want, want_state = _recurrence64(*arrays)
    matmul = {"3xtf32": _matmul_3xtf32, "tf32": _matmul_tf32}[products]
    got, state = ssd_scan_stages_ref(*(torch.tensor(v) for v in arrays), chunk=ops.CHUNK,
                                     return_state=True, matmul=matmul)
    worst_y, worst_state = _worst(got, want), _worst(state, want_state)
    with capsys.disabled():
        print(f"\n{products} products at chunk {ops.CHUNK}: largest error {worst_y:.3f} (y) and "
              f"{worst_state:.3f} (final state) of the SSD_RTOL bound")
    worst = max(worst_y, worst_state)
    if products == "3xtf32":
        assert worst < 0.5, worst
    else:
        assert worst > 2, worst
