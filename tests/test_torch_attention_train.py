"""The port's training attention paths against the JAX package's, on the CPU.

``blockwise_attention`` (the JAX package's ``xla_flash``) and
``chunked_attention`` (``chunked``): the forward and the gradients of q, k
and v (of the sum of the output times a fixed random cotangent) against
``jax.grad`` of the JAX functions on the same numpy inputs, with key and
query blocks small enough that every case spans several: causal, a sliding
window, GQA and MQA, a key count that is not a multiple of the block
(non-causal, padded), and the logit softcap.  ``attention_apply`` under
``xla_flash`` and ``chunked``: a prefill into a KV cache and decode steps
through the window's ring, against the JAX package's with the same impl.

Tolerance: float32 at rtol 1e-5, each array's atol 1e-5 times its largest
entry (both packages sum the same products in float32, in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention  # noqa: E402

RTOL = 1e-5

# (name, batch, sq, skv, hq, hkv, dh, causal, window, softcap)
CASES = [
    ("causal", 2, 45, 45, 4, 4, 16, True, None, None),
    ("window", 2, 45, 45, 4, 2, 16, True, 12, None),
    ("gqa", 1, 40, 40, 6, 2, 8, True, None, None),
    ("mqa", 2, 33, 33, 4, 1, 16, True, None, None),
    ("ragged-skv", 2, 20, 37, 4, 2, 16, False, None, None),
    ("softcap", 2, 45, 45, 4, 2, 16, True, None, 5.0),
    ("softcap-window-mqa", 1, 50, 50, 2, 1, 32, True, 9, 2.0),
]
BLOCK = 16      # key blocks (xla_flash) and query chunks (chunked) of the tests


def close_vec(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _inputs(case, seed=0):
    _, b, sq, skv, hq, hkv, dh, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    cot = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    return q, k, v, cot


PATHS = {
    "xla_flash": (attention.blockwise_attention, jax_attn.blockwise_attention, "block_k"),
    "chunked": (attention.chunked_attention, jax_attn.chunked_attention, "block_q"),
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_gradients_match_jax(path, case):
    port_fn, jax_fn, block = PATHS[path]
    *_, causal, window, cap = case
    kw = dict(causal=causal, window=window, softcap_val=cap, **{block: BLOCK})
    q, k, v, cot = _inputs(case)

    def jloss(q, k, v):
        return jnp.sum(jax_fn(q, k, v, **kw) * cot)

    jout = jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = port_fn(tq, tk, tv, **kw)
    close_vec(out.detach(), jout)
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(cot)), (tq, tk, tv))
    for name, g, jg in zip("qkv", grads, jgrads):
        assert bool(torch.isfinite(g).all()), name
        close_vec(g, jg)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_both_paths_equal_the_dense_path(case):
    """At the default blocks (one block here) and at small ones, both paths
    compute dense attention's function."""
    *_, causal, window, cap = case
    q, k, v, _ = (torch.tensor(x) for x in _inputs(case, seed=1))
    want = attention.dense_attention(q, k, v, causal=causal, window=window, softcap_val=cap)
    for fn, block in ((attention.blockwise_attention, "block_k"),
                      (attention.chunked_attention, "block_q")):
        for size in (BLOCK, 512):
            got = fn(q, k, v, causal=causal, window=window, softcap_val=cap, **{block: size})
            close_vec(got, want)


def test_bf16_inputs_give_bf16_outputs_of_the_float32_math():
    case = CASES[1]
    q, k, v, _ = (torch.tensor(x).to(torch.bfloat16) for x in _inputs(case))
    for fn in (attention.blockwise_attention, attention.chunked_attention):
        got = fn(q, k, v, causal=True, window=12)
        want = fn(q.float(), k.float(), v.float(), causal=True, window=12)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# attention_apply: prefill into a cache and decode steps
# ---------------------------------------------------------------------------

def _cfg(pkg):
    cfg = pkg.reduced(pkg.get_config("h2o-danube-3-4b"), d_model=256)
    return dataclasses.replace(cfg, sliding_window=24)


@pytest.fixture(scope="module")
def layer():
    jcfg = _cfg(jax_configs)
    from repro.models.common import init_params
    jp = init_params(jax.random.PRNGKey(3), jax_attn.attention_defs(jcfg), jnp.float32)
    return jp, params_from_jax(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("impl", ["xla_flash", "chunked"])
def test_prefill_and_decode_through_the_cache_match_jax(layer, impl):
    jp, tp = layer
    jcfg, tcfg = _cfg(jax_configs), _cfg(configs)
    rng = np.random.default_rng(5)
    b, s, steps = 2, 40, 6                      # the prompt outruns the 24-slot window ring
    x = rng.standard_normal((b, s + steps, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc = jax_attn.init_kv_cache(jcfg, b, s + steps, jnp.float32)
    tc = attention.init_kv_cache(tcfg, b, s + steps, torch.float32, "cpu")
    want, jc = jax_attn.attention_apply(jp, jnp.asarray(x[:, :s]), jcfg,
                                        positions=jnp.asarray(pos), cache=jc, impl=impl)
    got, tc = attention.attention_apply(tp, torch.tensor(x[:, :s]), tcfg,
                                        positions=torch.tensor(pos), cache=tc, impl=impl)
    close_vec(got, want)
    for t in range(s, s + steps):
        want, jc = jax_attn.attention_apply(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, positions=jnp.full((b, 1), t, jnp.int32),
            cache=jc, decode_pos=jnp.int32(t), impl=impl)
        got, tc = attention.attention_apply(
            tp, torch.tensor(x[:, t:t + 1]), tcfg, positions=torch.full((b, 1), t), cache=tc,
            decode_pos=t, impl=impl)
        close_vec(got, want)
    for key in ("k", "v"):
        close_vec(tc[key], jc[key])
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))


@pytest.mark.parametrize("impl", ["xla_flash", "chunked"])
def test_the_no_cache_forward_is_differentiable_and_matches_jax(layer, impl):
    """attention_apply without a cache (the training forward): output and the
    gradients of the projections against jax.grad."""
    jp, tp = layer
    jcfg, tcfg = _cfg(jax_configs), _cfg(configs)
    rng = np.random.default_rng(6)
    b, s = 2, 30
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))

    def jloss(p):
        y, _ = jax_attn.attention_apply(p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                        impl=impl)
        return jnp.sum(y * cot)

    jg = jax.grad(jloss)(jp)
    leaves = {n: t.clone().requires_grad_() for n, t in tp.items()}
    y, _ = attention.attention_apply(leaves, torch.tensor(x), tcfg, positions=torch.tensor(pos),
                                     impl=impl)
    grads = torch.autograd.grad(torch.sum(y * torch.tensor(cot)), list(leaves.values()))
    for (name, _), g in zip(leaves.items(), grads):
        close_vec(g, jg[name])

