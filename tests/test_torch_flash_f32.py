"""The float32 tensor-core flash kernel's rounding order, on the CPU: the JAX
package's flash kernel (Pallas in interpret mode, through
``flash_attention_kernel_call``), the port's ``attention_ref`` and
``attention_tc_ref(products="3xtf32")`` at the kernel's key tile
(``ops.f32_block_k``), on the same numpy inputs; and the dispatch of float32
to that kernel.

The JAX kernel runs with 32 x 32 tiles on inputs padded to them, so S = 100
leaves a ragged last tile and a ragged ``kv_len`` reaches its mask.
Tolerance: chip_smoke.py's FLASH_TOL for float32, rtol 1e-5 and atol 1e-5
(online softmax in other tile orders: float32 sums in other orders).  The
3xTF32 order (each operand split into TF32 hi and lo, lo*lo dropped) keeps
well inside it against both; TF32 products alone leave it many times over,
which is why the kernel splits its operands.  Run with -s to see how much of
the tolerance each uses.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_kernel_call  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (attention_ref, attention_tc_ref,  # noqa: E402
                                                     einsum_products, tf32)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RTOL, ATOL = chip_smoke.FLASH_TOL["float32"]
TILE = 32   # the JAX kernel's block_q and block_k here
CASES = {  # b, hq, hkv, sq, skv, dh, causal, window, kv_len
    "dh64-causal-gqa4/2": (1, 4, 2, 100, 100, 64, True, None, None),
    "dh64-noncausal-mqa4/1-sq50-skv150-kv_len130": (1, 4, 1, 50, 150, 64, False, None, 130),
    "dh120-causal-window16-under-a-tile-gqa4/2": (1, 4, 2, 100, 100, 120, True, 16, None),
    "dh120-noncausal-mqa4/1-kv_len77": (2, 4, 1, 100, 100, 120, False, None, 77),
    "dh256-causal-mqa8/1-kv_len90": (1, 8, 1, 100, 100, 256, True, None, 90),
    "dh256-noncausal-window40-gqa4/2": (1, 4, 2, 100, 100, 256, False, 40, None),
}


def _qkv(b, hq, hkv, sq, skv, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))


def _jax_kernel(q, k, v, *, causal, window, kv_len):
    """The Pallas kernel in interpret mode on inputs padded to its tiles."""
    def pad(x):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, -x.shape[2] % TILE), (0, 0)))

    out = flash_attention_kernel_call(pad(q), pad(k), pad(v), causal=causal, window=window,
                                      kv_len=kv_len, block_q=TILE, block_k=TILE, interpret=True)
    return np.asarray(out)[:, :, :q.shape[2]]


def _share(got, want) -> float:
    """The largest error of ``got`` as a share of the tolerance around ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def _three(case):
    """The JAX kernel's output, attention_ref's and a function of ``products``
    giving the kernel's order, on the case's inputs."""
    b, hq, hkv, sq, skv, dh, causal, window, kv_len = CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh, seed=sq + skv + dh)
    kw = dict(causal=causal, window=window)
    want = _jax_kernel(q, k, v, kv_len=skv if kv_len is None else kv_len, **kw)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    plain = attention_ref(tq, tk, tv, kv_len=kv_len, **kw).numpy()

    def order(products):
        return attention_tc_ref(tq, tk, tv, kv_len=kv_len, block_k=ops.f32_block_k(dh),
                                products=products, **kw).numpy()
    return want, plain, order


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_order_matches_the_jax_kernel_and_attention_ref(case, capsys):
    want, plain, order = _three(case)
    got = order("3xtf32")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain, want, rtol=RTOL, atol=ATOL)
    with capsys.disabled():
        print(f"\n3xTF32 order, {case}: {_share(got, want):.3f} of the float32 tolerance "
              f"against the JAX kernel, {_share(got, plain):.3f} against attention_ref")
    assert max(_share(got, want), _share(got, plain)) < 0.5


def _tf32_products(eq, a, b, products):
    """One TF32 product (hi*hi) in place of the three of the split."""
    return torch.einsum(eq, tf32(a), tf32(b))


@pytest.mark.parametrize("case", [c for c in CASES if "causal-" in c and "non" not in c])
def test_tf32_products_alone_leave_the_tolerance(case, capsys, monkeypatch):
    """The kernel's order with TF32 products alone: the kernel could not meet
    the float32 tolerance without splitting its operands."""
    want, _, order = _three(case)
    monkeypatch.setattr(ref, "einsum_products", _tf32_products)
    share = _share(order("3xtf32"), want)
    with capsys.disabled():
        print(f"\nTF32 products alone, {case}: {share:.1f} times the float32 tolerance against "
              "the JAX kernel")
    assert share > 2


def test_3xtf32_products_split_as_the_kernel_does():
    """tf32 rounds to nearest with ties away from zero, to 10 stored bits; the
    three products of the split agree with a float64 product far better than
    one TF32 product does."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0])
    assert tf32(x).tolist() == [1.0, 1 + 2**-10, 1 + 4 * 2**-11, -(1 + 2**-10), 1.0, 3.0]
    rng = np.random.default_rng(0)
    a, b = (torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in ((16, 256), (256, 8)))
    exact = a.double() @ b.double()
    err3 = (einsum_products("ij,jk->ik", a, b, "3xtf32").double() - exact).abs().max()
    err1 = (_tf32_products("ij,jk->ik", a, b, "tf32").double() - exact).abs().max()
    err32 = (einsum_products("ij,jk->ik", a, b).double() - exact).abs().max()
    assert err3 < 4 * err32 and err1 > 100 * err3
    with pytest.raises(ValueError, match="products"):
        einsum_products("ij,jk->ik", a, b, "fp16")


@pytest.mark.parametrize("dh,block_k", [(8, 64), (64, 64), (120, 64), (128, 64), (136, 32),
                                        (192, 32), (200, 16), (256, 16)])
def test_f32_block_k_is_64_up_to_dh128_32_up_to_192_and_16_above(dh, block_k):
    assert ops.f32_block_k(dh) == block_k


def test_the_models_float32_views_go_to_the_f32_kernel_with_16_byte_loads():
    """h2o-danube-3-4b's (B, S, H, Dh) float32 projections as transposed
    views: the float32 kernel, 16-byte loads; a Dh or an offset that breaks
    16-byte alignment keeps the same kernel with 4-byte loads."""
    b, s = 2, 300
    q = torch.zeros(b, s, 32, 120).transpose(1, 2)
    k = torch.zeros(b, s, 8, 120).transpose(1, 2)
    assert ops.kernel_for(q) == ops.kernel_for(k) == "f32"
    assert ops._vec4(q, k, k)
    odd = torch.zeros(1, 2, 8, 99)
    assert ops.kernel_for(odd) == "f32" and not ops._vec4(odd, odd, odd)
    shifted = torch.zeros(1, 2, 8, 129)[..., 1:]   # a base 4 bytes past 16-byte alignment
    assert ops.kernel_for(shifted) == "f32" and not ops._vec4(shifted, shifted, shifted)


def test_cpu_tensors_run_the_plain_version_and_never_the_kernel():
    q, k, v = map(torch.tensor, _qkv(1, 4, 2, 40, 40, 120, seed=3))
    before = (ops.flash_attention.launches, ops.flash_attention.launches_f32)
    got = flash_attention(q, k, v, causal=True, window=16)
    assert (ops.flash_attention.launches, ops.flash_attention.launches_f32) == before
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=True, window=16), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.f32_kernel(q, k, v)
