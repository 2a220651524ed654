"""Flash attention at gemma-2b's head_dim of 256: the port's plain versions
against the JAX package's flash kernel, and the dispatch of bf16 Dh 256 to the
tensor-core kernel's 64-key route.

The JAX kernel runs as its own tests run it on the CPU: Pallas in interpret
mode, 32 x 32 tiles, called through ``flash_attention_kernel_call`` on inputs
padded to its tiles so that a ragged ``kv_len`` reaches its mask.  The port's
``flash_attention`` on CPU tensors is ``attention_ref``; ``attention_tc_ref``
at ``ops.tc_block_k(256)`` (64 keys) is the tensor-core kernel's rounding
order at this head dim.  Inputs are made with numpy from fixed seeds; S = 100
leaves a ragged last tile at every tile size.  Tolerance: float32 at rtol
1e-5 and atol 1e-5 (online softmax in other tile orders: float32 sums in
other orders); in bf16 the tensor-core order, whose p is rounded to bf16
before p.v, within chip_smoke.py's derived P-rounding bounds of the JAX
package's float32 p (P_MAX, P_MEAN).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_kernel_call  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_tc_ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = dict(rtol=1e-5, atol=1e-5)
DH = 256
TILE = 32   # the JAX kernel's block_q and block_k here
CASES = {  # b, hq, hkv, sq, skv, causal, window, kv_len
    "mqa8/1-causal": (1, 8, 1, 100, 100, True, None, None),
    "mqa8/1-causal-kv_len77": (2, 8, 1, 100, 100, True, None, 77),
    "mqa8/1-noncausal-sq50-skv150-kv_len130": (1, 8, 1, 50, 150, False, None, 130),
    "gqa4/2-noncausal-window40-kv_len90": (1, 4, 2, 100, 100, False, 40, 90),
    "mqa4/1-causal-window16": (2, 4, 1, 100, 100, True, 16, None),
}


def _qkv(b, hq, hkv, sq, skv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, DH), (b, hkv, skv, DH), (b, hkv, skv, DH)))


def _jax_kernel(q, k, v, *, causal, window, kv_len):
    """The Pallas kernel in interpret mode on inputs padded to its tiles."""
    def pad(x):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, -x.shape[2] % TILE), (0, 0)))

    out = flash_attention_kernel_call(pad(q), pad(k), pad(v), causal=causal, window=window,
                                      kv_len=kv_len, block_q=TILE, block_k=TILE, interpret=True)
    return np.asarray(out)[:, :, :q.shape[2]]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_jax_kernel_at_dh256(case):
    b, hq, hkv, sq, skv, causal, window, kv_len = CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, skv, seed=sq + skv)
    kw = dict(causal=causal, window=window)
    want = _jax_kernel(q, k, v, kv_len=skv if kv_len is None else kv_len, **kw)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    before = ops.flash_attention.launches
    got = flash_attention(tq, tk, tv, kv_len=kv_len, **kw).numpy()
    assert ops.flash_attention.launches == before   # the CPU runs the plain version
    np.testing.assert_allclose(got, want, **TOL)
    tc = attention_tc_ref(tq, tk, tv, kv_len=kv_len, block_k=ops.tc_block_k(DH), **kw).numpy()
    np.testing.assert_allclose(tc, want, **TOL)
    if kv_len is None:
        np.testing.assert_allclose(got, np.asarray(jax_ref(*map(jnp.asarray, (q, k, v)), **kw)),
                                   **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_tc_order_at_dh256_in_bf16_is_within_the_p_rounding_bounds_of_jax(case):
    b, hq, hkv, sq, skv, causal, window, kv_len = CASES[case]
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(b, hq, hkv, sq, skv, seed=sq))
    kw = dict(causal=causal, window=window)
    got = attention_tc_ref(q, k, v, kv_len=kv_len, block_k=ops.tc_block_k(DH), **kw)
    want = _jax_kernel(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)),
                       kv_len=skv if kv_len is None else kv_len, **kw)
    chip_smoke.p_rounding(got, torch.tensor(want.astype(np.float32)), v, case)


@pytest.mark.parametrize("dh,block_k", [(8, 128), (120, 128), (128, 128), (136, 64), (192, 64),
                                        (256, 64)])
def test_tc_block_k_is_128_up_to_dh128_and_64_above(dh, block_k):
    assert ops.tc_block_k(dh) == block_k


def test_gemmas_views_go_to_the_tensor_cores_with_tma_strides():
    """gemma-2b's (B, S, H, Dh) projections, 8 query heads and one KV head of
    256, handed to the kernel as transposed (B, H, S, Dh) views."""
    b, s = 2, 8176
    q = torch.zeros(b, s, 8, DH, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(b, s, 1, DH, dtype=torch.bfloat16).transpose(1, 2)
    assert ops.kernel_for(q) == ops.kernel_for(k) == "tc"
    assert ops.tma_strides(q) == (s * 8 * DH, DH, 8 * DH)
    assert ops.tma_strides(k) == (s * DH, 8, DH)   # the size-1 head axis is never stepped
    assert ops.kernel_for(q.float()) == "f32"   # float32: the 3xTF32 tensor-core kernel
    assert ops.kernel_for(torch.zeros(1, 1, 4, 264, dtype=torch.bfloat16)) == "simt"
    with pytest.raises(ValueError, match="multiples of 8"):   # a row stride of 260
        ops.tma_strides(torch.zeros(1, 4, 1, 260, dtype=torch.bfloat16)[..., :256]
                        .transpose(1, 2))
