"""The port's flash_attention (its plain version, on the CPU) against the JAX
package's flash_attention (Pallas, interpret mode) and attention_ref; the
tensor-core kernel's rounding order (``ref.attention_tc_ref``) against both;
the wrapper's dispatch rule and TMA stride checks.

Inputs are made with numpy from fixed seeds and handed to both packages.  The
JAX kernel runs with 32 x 32 tiles, so S = 100 pads to 128 and exercises its
kv_len mask and its online softmax across tiles.  Tolerance: float32 at rtol
1e-5 and atol 1e-5 (dense softmax against online softmax: float32 sums in
other orders).  The tensor-core order in bf16 rounds p to bf16 before p.v:
against the JAX package's float32 p it is held to chip_smoke.py's derived
P-rounding bounds (P_MAX, P_MEAN).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_tc_ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {  # b, hq, hkv, s, dh, causal, window
    "causal-gqa4/2-dh64": (1, 4, 2, 64, 64, True, None),
    "noncausal-mqa4/1-dh120": (2, 4, 1, 48, 120, False, None),
    "window16-s100-gqa4/2-dh120": (1, 4, 2, 100, 120, True, 16),
    "window16-s100-mqa4/1-dh64-noncausal": (1, 4, 1, 100, 64, False, 16),
    "ragged-s77-gqa4/2-dh120": (2, 4, 2, 77, 120, True, None),
}


def _qkv(b, hq, hkv, sq, skv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_kernel_and_ref(case):
    b, hq, hkv, s, dh, causal, window = CASES[case]
    q, k, v = _qkv(b, hq, hkv, s, s, dh, seed=s + dh)
    before = ops.flash_attention.launches
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=window).numpy()
    assert ops.flash_attention.launches == before   # the CPU runs the plain version
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv, causal=causal,
                                                       window=window)), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_masks_the_padded_keys(causal):
    # keys at or past kv_len are padding: the result is attention over the first kv_len
    q, k, v = _qkv(1, 4, 2, 60, 60, 64, seed=5)
    got = flash_attention(*map(torch.tensor, (q, k, v)), causal=causal, kv_len=41).numpy()
    cut = slice(None, 41)
    want = jax_ref(*map(jnp.asarray, (q[:, :, cut], k[:, :, cut], v[:, :, cut])), causal=causal)
    np.testing.assert_allclose(got[:, :, cut], np.asarray(want), **TOL)
    if not causal:
        rest = jax_ref(*map(jnp.asarray, (q, k[:, :, cut], v[:, :, cut])), causal=False)
        np.testing.assert_allclose(got, np.asarray(rest), **TOL)


def test_bf16_in_bf16_out():
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(1, 2, 1, 40, 40, 32))
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    want = jax_ref(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)))
    # both compute in float32 from the same bf16 inputs and round once: one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2**-7, atol=1e-4)


def test_rejects_misshapen_inputs():
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(x, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, window=0)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(x, x, x, kv_len=9)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(x, x.double(), x)


@pytest.mark.parametrize("case", list(CASES))
def test_tc_order_in_float32_matches_jax(case):
    # with float32 inputs p is not rounded: the tensor-core kernel's order is
    # then an online softmax over 128-key tiles, as the JAX kernel's over 32
    b, hq, hkv, s, dh, causal, window = CASES[case]
    q, k, v = _qkv(b, hq, hkv, s, s, dh, seed=s + dh)
    got = attention_tc_ref(*map(torch.tensor, (q, k, v)), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv, causal=causal,
                                                       window=window)), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_tc_order_in_bf16_is_within_the_p_rounding_bounds_of_jax(case):
    b, hq, hkv, s, dh, causal, window = CASES[case]
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(b, hq, hkv, s, s, dh, seed=s))
    got = attention_tc_ref(q, k, v, causal=causal, window=window)
    want = jax_ref(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v)),
                   causal=causal, window=window)
    chip_smoke.p_rounding(got, torch.tensor(np.asarray(want, np.float32)), v, case)


def test_a_window_one_too_wide_fails_the_tight_check():
    # chip_smoke.py's tight check of the tensor-core kernel, with its rounding
    # order standing in for the kernel: the right window passes, one key more fails
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(1, 4, 2, 400, 400, 120, seed=9))
    got = attention_tc_ref(q, k, v, causal=True, window=64)
    for window, passes in ((64, True), (65, False)):
        _, ratio = chip_smoke.flash_excess(got, *chip_smoke.tc_reference(q, k, v, causal=True,
                                                                          window=window))
        assert (ratio <= 1) == passes


@pytest.mark.parametrize("dtype,dh,kernel", [
    (torch.bfloat16, 120, "tc"), (torch.bfloat16, 128, "tc"), (torch.bfloat16, 32, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.float32, 120, "f32"), (torch.float32, 64, "f32"),
    (torch.bfloat16, 136, "tc"), (torch.bfloat16, 264, "simt"), (torch.float32, 256, "f32"),
    (torch.float32, 100, "f32"), (torch.float32, 264, "simt"),
])
def test_kernel_for_routes_by_dtype_and_head_dim(dtype, dh, kernel):
    assert ops.kernel_for(torch.zeros(1, 2, 3, dh, dtype=dtype)) == kernel


def test_tma_strides_take_the_models_views_and_refuse_misaligned_ones():
    bf16 = torch.bfloat16
    view = torch.zeros(2, 300, 8, 120, dtype=bf16).transpose(1, 2)   # the model's (B, S, H, Dh)
    assert ops.tma_strides(view) == (300 * 8 * 120, 120, 8 * 120)
    one = torch.zeros(1, 1, 5, 64, dtype=bf16)                       # size-1 dims: never stepped
    assert ops.tma_strides(one) == (8, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        ops.tma_strides(torch.zeros(1, 2, 8, 128, dtype=bf16)[..., 1:121])
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.tma_strides(torch.zeros(1, 2, 8, 124, dtype=bf16)[..., :120])
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.tma_strides(torch.zeros(1, 2, 8, 100, dtype=bf16))
