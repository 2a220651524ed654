"""The port's Mamba2 block and SSM DecoderLM against the JAX package's, on
the CPU, and the bounds of chip_smoke.py's full-width Mamba2 serve check.

Weights and inputs are made in the JAX package (numpy seeds,
``DecoderLM.init``) and carried across with ``repro_torch.convert``.  The
JAX package's init zeroes ``ssm_a_log`` and ``ssm_dt_bias`` (A = -1, dt about
0.8), so its state forgets within a few tokens and a lost carry between
chunks would not show; here both are drawn from Mamba2's initial ranges (A
= U(1, 16), dt log-uniform in [1e-3, 1e-1], dt_bias = softplus^-1(dt);
arXiv:2405.21060) so that the state carries across chunks.  The JAX package
runs its chunked SSD (``ssd_chunked``); the port runs both of its paths:
``kernel`` (on the CPU the kernel's plain recurrence) and ``dense``
(``ssd_chunked``).  Tolerance: float32 at rtol 1e-5 and atol 1e-5; what lies
downstream of the first layer (logits, the second layer's cache) at rtol
1e-5 and atol 3e-5, as for the dense decoders; the final-normed hidden
states at rtol 1e-5 and atol 1e-5 of their largest value.  The bounds of
chip_smoke.py's full-width Mamba2 check are held in
``test_torch_ssm_drift.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import decoder_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import DecoderLM, ssm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
DEEP_TOL = dict(rtol=1e-5, atol=3e-5)   # downstream of the first layer
PROMPT, DECODE_STEPS = 300, 4           # the prompt spans three 128-step chunks, ragged
JAX_CFG = jax_configs.reduced(jax_configs.get_config("mamba2-2.7b"))
PORT_CFG = configs.reduced(configs.get_config("mamba2-2.7b"))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _mamba2_ranges(rng, shape):
    """(a_log, dt_bias) drawn as Mamba2 initialises them, float32 numpy."""
    u = torch.from_numpy(rng.random((2, *np.atleast_1d(shape))).astype(np.float32))
    return tuple(t.numpy() for t in chip_smoke.mamba2_a_log_dt_bias(u))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


class TestSSMApply:
    """One Mamba2 layer: prefill into the cache, then decode steps."""

    @pytest.fixture(scope="class")
    def layer(self):
        rng = np.random.default_rng(0)
        defs = jax_ssm.ssm_defs(JAX_CFG)
        p = {n: (rng.standard_normal(d.shape) / np.sqrt(d.fan_in)).astype(np.float32)
             for n, d in defs.items()}
        p["ssm_a_log"], p["ssm_dt_bias"] = _mamba2_ranges(rng, JAX_CFG.ssm_heads)
        return {n: jnp.asarray(a) for n, a in p.items()}, params_from_jax(p, "cpu")

    def _x(self, s, seed):
        return np.random.default_rng(seed).standard_normal((2, s, JAX_CFG.d_model)).astype(
            np.float32)

    @pytest.mark.parametrize("impl", ["kernel", "dense"])
    def test_no_cache(self, layer, impl):
        jp, tp = layer
        x = self._x(150, 1)
        want, _ = jax_ssm.ssm_apply(jp, jnp.asarray(x), JAX_CFG)
        got, cache = ssm.ssm_apply(tp, torch.tensor(x), PORT_CFG, impl=impl)
        assert cache is None
        np.testing.assert_allclose(_np(got), _np(want), **TOL)

    @pytest.mark.parametrize("impl", ["kernel", "dense"])
    def test_prefill_then_decode(self, layer, impl):
        jp, tp = layer
        jc = jax_ssm.init_ssm_cache(JAX_CFG, 2)
        tc = ssm.init_ssm_cache(PORT_CFG, 2)
        x = self._x(PROMPT, 2)
        want, jc = jax_ssm.ssm_apply(jp, jnp.asarray(x), JAX_CFG, cache=jc)
        got, same = ssm.ssm_apply(tp, torch.tensor(x), PORT_CFG, cache=tc, impl=impl)
        assert same is tc                   # updated in place
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for t in range(8):
            xt = self._x(1, 100 + t)
            want, jc = jax_ssm.ssm_apply(jp, jnp.asarray(xt), JAX_CFG, cache=jc)
            got, tc = ssm.ssm_apply(tp, torch.tensor(xt), PORT_CFG, cache=tc, impl=impl)
            np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}", **TOL)
        for key in ("conv", "state"):
            assert tc[key].dtype == torch.float32
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), err_msg=key, **TOL)

    def test_short_prefill_and_unknown_impl_raise(self, layer):
        """A prefill shorter than the conv window's cached steps, then decode
        steps, equals one prefill of the same tokens (the JAX package
        corrupts the decode steps after such a prefill, so it is no
        reference here); an unknown impl raises."""
        _, tp = layer
        width = PORT_CFG.ssm_conv_width
        x = self._x(width + 2, 3)
        for impl in ("kernel", "dense"):
            for short in range(1, width - 1):
                whole, wc = ssm.ssm_apply(tp, torch.tensor(x), PORT_CFG,
                                          cache=ssm.init_ssm_cache(PORT_CFG, 2), impl=impl)
                got, tc = ssm.ssm_apply(tp, torch.tensor(x[:, :short]), PORT_CFG,
                                        cache=ssm.init_ssm_cache(PORT_CFG, 2), impl=impl)
                outs = [got]
                for t in range(short, x.shape[1]):
                    y, tc = ssm.ssm_apply(tp, torch.tensor(x[:, t:t + 1]), PORT_CFG, cache=tc,
                                          impl=impl)
                    outs.append(y)
                np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(whole),
                                           err_msg=f"{impl} prefill {short}", **TOL)
                for key in ("conv", "state"):
                    np.testing.assert_allclose(_np(tc[key]), _np(wc[key]), err_msg=key, **TOL)
        with pytest.raises(ValueError, match="unknown impl"):
            ssm.ssm_apply(tp, torch.tensor(self._x(5, 3)), PORT_CFG, impl="pallas")


@pytest.fixture(scope="module", params=["kernel", "dense"])
def served(request):
    """Reduced mamba2 served by both packages: prefill, then decode steps;
    logits and caches after each."""
    jm = JaxDecoderLM(JAX_CFG)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["blocks"]["ssm_a_log"], params["blocks"]["ssm_dt_bias"] = _mamba2_ranges(
        rng, (JAX_CFG.num_layers, JAX_CFG.ssm_heads))
    tm = decoder_from_jax(PORT_CFG, params, "cpu")
    tm.attn_impl = request.param
    tokens = rng.integers(0, JAX_CFG.vocab_size, (2, PROMPT)).astype(np.int32)
    out = {"jax": [], "port": []}
    before = ops.ssd_scan.launches
    jl, jc = jm.prefill(params, jnp.asarray(tokens), jm.init_cache(2, PROMPT + DECODE_STEPS))
    tl, tc = tm.prefill(torch.tensor(tokens).long(), tm.init_cache(2, PROMPT + DECODE_STEPS))
    assert ops.ssd_scan.launches == before   # the CPU runs the plain versions
    out["jax"].append((jl, jax.device_get(jc)))
    out["port"].append((tl, _stack_caches(tc)))
    decode = jax.jit(jm.decode_step)
    for i in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode(params, jnp.asarray(tok), jnp.int32(PROMPT + i), jc)
        tl, tc = tm.decode_step(torch.tensor(tok).long(), PROMPT + i, tc)
        out["jax"].append((jl, jax.device_get(jc)))
        out["port"].append((tl, _stack_caches(tc)))
    return out, params, tm


def _stack_caches(caches):
    return {k: torch.stack([c[k] for c in caches["blocks"]]).clone() for k in ("conv", "state")}


def test_decoder_prefill_and_decode_logits(served):
    out, _, _ = served
    for step, ((jl, _), (tl, _)) in enumerate(zip(out["jax"], out["port"])):
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"step {step}", **DEEP_TOL)


def test_decoder_caches_are_float32_and_match(served):
    out, _, _ = served
    for step, ((_, jc), (_, tc)) in enumerate(zip(out["jax"], out["port"])):
        for key in ("conv", "state"):
            assert tc[key].dtype == torch.float32
            for layer, tol in enumerate((TOL, DEEP_TOL)):
                np.testing.assert_allclose(_np(tc[key][layer]), jc["blocks"][key][layer],
                                           err_msg=f"{key} layer {layer} step {step}", **tol)


def test_decoder_forward_matches(served):
    """The final-normed hidden states at every position.  Atol is 1e-5 of
    their largest value: the out-projections' float32 sums in other orders
    differ by 5e-6 of that scale, which the final norm then divides by the
    residual's rms (0.8)."""
    _, params, tm = served
    tokens = np.random.default_rng(3).integers(0, JAX_CFG.vocab_size, (1, 77)).astype(np.int32)
    want = _np(JaxDecoderLM(JAX_CFG).forward(params, jnp.asarray(tokens))[0])
    np.testing.assert_allclose(_np(tm(torch.tensor(tokens).long())), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_a_bf16_model_keeps_float32_caches():
    model = DecoderLM(PORT_CFG, dtype=torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 64)
    assert len(caches["blocks"]) == PORT_CFG.num_layers
    tokens = torch.randint(0, PORT_CFG.vocab_size, (2, 20), generator=torch.Generator())
    logits, caches = model.prefill(tokens, caches)
    logits, caches = model.decode_step(logits.argmax(-1), 20, caches)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    for c in caches["blocks"]:
        assert c["conv"].dtype == torch.float32 and c["state"].dtype == torch.float32
        assert c["state"].abs().max() > 0
