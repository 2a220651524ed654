"""The port's model zoo (configs, common blocks, MLP, attention, DecoderLM)
against the JAX package's, on the CPU.

Inputs and weights are made in the JAX package (numpy seeds, ``DecoderLM.init``)
and carried across with ``repro_torch.convert``.  JAX runs its Pallas flash
kernel in interpret mode (``attn_impl="pallas"``); the port runs its kernel
path, which on the CPU is the kernel's plain version.  Configs:
``reduced(h2o-danube-3-4b)`` (window 64, MQA 2/1, SwiGLU, untied head), a
GQA 4/2 head_dim-120 variant of it, ``reduced(gemma-2b)`` (MQA, GeGLU, tied
embeddings), ``reduced(command-r-plus-104b)`` (parallel block), and two more
variants of the first: with qk-norm, and with sinusoidal positions.
Tolerance: float32 at rtol 1e-5 and atol 1e-5.  What lies downstream of the
first layer (the second layer's K/V caches and the logits) is held at rtol
1e-5 and atol 3e-5: the float32 rounding of the first layer's output reaches
the second layer's keys at up to 1.1e-5 absolute.

The drift tests behind chip_smoke.py's serve bounds are in
``test_torch_models_bf16_drift.py``, ``test_torch_models_gemma_drift.py``
and ``test_torch_models_f32_drift.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import decoder_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import attention, common, mlp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
DEEP_TOL = dict(rtol=1e-5, atol=3e-5)   # downstream of the first layer
PROMPT, CACHE_LEN, DECODE_STEPS = 80, 96, 4   # the prompt outruns the 64-slot window ring


def _cfgs(pkg):
    h2o = pkg.reduced(pkg.get_config("h2o-danube-3-4b"))
    return {
        "h2o": h2o,
        "h2o-gqa4/2-dh120": dataclasses.replace(h2o, num_heads=4, num_kv_heads=2, head_dim=120),
        "gemma": pkg.reduced(pkg.get_config("gemma-2b")),
        "command-r": pkg.reduced(pkg.get_config("command-r-plus-104b")),
        # branches of chameleon and whisper (tests/test_torch_encdec.py holds
        # whisper's EncDecLM): qk-norm, and sinusoidal positions in place of RoPE
        "h2o-qk-norm": dataclasses.replace(h2o, qk_norm=True),
        "h2o-sinusoidal": dataclasses.replace(h2o, use_rope=False),
    }


JAX_CFGS, PORT_CFGS = _cfgs(jax_configs), _cfgs(configs)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_configs_are_the_jax_packages():
    assert sorted(configs.ARCHS) == sorted(jax_configs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        want = jax_configs.get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert dataclasses.asdict(configs.reduced(cfg)) == dataclasses.asdict(
            jax_configs.reduced(want)), name
        if cfg.num_heads:
            assert cfg.resolved_head_dim == want.resolved_head_dim
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert dataclasses.asdict(configs.FederatedConfig()) == \
        dataclasses.asdict(jax_configs.FederatedConfig())


class TestCommon:
    rng = np.random.default_rng(0)

    def test_rms_norm(self):
        x = 3 * self.rng.standard_normal((2, 5, 64)).astype(np.float32)
        scale = 0.1 * self.rng.standard_normal(64).astype(np.float32)
        _close(common.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6),
               jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))

    @pytest.mark.parametrize("dh", [64, 120])
    def test_rope(self, dh):
        x = self.rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
        pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
        _close(common.rope(torch.tensor(x), torch.tensor(pos), 10000.0),
               jax_common.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))

    def test_sinusoidal_positions_and_softcap(self):
        _close(common.sinusoidal_positions(50, 32), jax_common.sinusoidal_positions(50, 32))
        x = 40 * self.rng.standard_normal(20).astype(np.float32)
        _close(common.softcap(torch.tensor(x), 30.0), jax_common.softcap(jnp.asarray(x), 30.0))

    def test_init_params_distribution(self):
        defs = {"w": common.Param((400, 300), ("embed", "ff")), "n_norm": common.Param((7,), (None,)),
                "b_b": common.Param((3, 2), (None, None))}
        out = common.init_params(torch.Generator().manual_seed(0), defs, torch.float32)
        assert float(out["w"].std()) == pytest.approx(1 / 20, rel=0.02)
        assert not out["n_norm"].any() and not out["b_b"].any()


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(activation):
    jcfg = dataclasses.replace(JAX_CFGS["h2o"], activation=activation, use_bias=True)
    tcfg = dataclasses.replace(PORT_CFGS["h2o"], activation=activation, use_bias=True)
    rng = np.random.default_rng(1)
    params = {n: (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
              for n, p in jax_mlp.mlp_defs(jcfg).items()}
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    want = jax_mlp.mlp_apply({n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), jcfg)
    got = mlp.mlp_apply(params_from_jax(params, "cpu"), torch.tensor(x), tcfg)
    _close(got, want)


@pytest.fixture(scope="module", params=list(JAX_CFGS))
def served(request):
    """One config served by both packages: prefill, then decode steps past
    the ring's wrap; logits and caches after each."""
    name = request.param
    jcfg, tcfg = JAX_CFGS[name], PORT_CFGS[name]
    jm = JaxDecoderLM(jcfg, attn_impl="pallas")
    params = jm.init(jax.random.PRNGKey(0))
    tm = decoder_from_jax(tcfg, jax.device_get(params), "cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    out = {"jax": [], "port": []}
    jl, jc = jm.prefill(params, jnp.asarray(tokens), jm.init_cache(2, CACHE_LEN, jnp.float32))
    tl, tc = tm.prefill(torch.tensor(tokens).long(), tm.init_cache(2, CACHE_LEN))
    out["jax"].append((jl, jax.device_get(jc)))
    out["port"].append((tl, _stack_caches(tc)))
    decode = jax.jit(jm.decode_step)
    for i in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode(params, jnp.asarray(tok), jnp.int32(PROMPT + i), jc)
        tl, tc = tm.decode_step(torch.tensor(tok).long(), PROMPT + i, tc)
        out["jax"].append((jl, jax.device_get(jc)))
        out["port"].append((tl, _stack_caches(tc)))
    return name, out, jcfg, params


def _stack_caches(caches):
    return {k: torch.stack([c[k] for c in caches["blocks"]]).clone() for k in ("k", "v", "slot_pos")}


def test_decoder_prefill_and_decode_logits(served):
    _, out, _, _ = served
    for step, ((jl, _), (tl, _)) in enumerate(zip(out["jax"], out["port"])):
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"step {step}", **DEEP_TOL)


def test_decoder_caches(served):
    _, out, jcfg, _ = served
    for step, ((_, jc), (_, tc)) in enumerate(zip(out["jax"], out["port"])):
        for key in ("k", "v"):
            for layer, tol in enumerate((TOL, DEEP_TOL)):
                np.testing.assert_allclose(_np(tc[key][layer]), jc["blocks"][key][layer],
                                           err_msg=f"{key} layer {layer} step {step}", **tol)
        np.testing.assert_array_equal(_np(tc["slot_pos"]), jc["blocks"]["slot_pos"])
    if jcfg.sliding_window:   # the ring wrapped: the oldest slots hold the newest positions
        assert int(out["port"][-1][1]["slot_pos"].max()) == PROMPT + DECODE_STEPS - 1
        assert out["port"][-1][1]["slot_pos"].shape[-1] == jcfg.sliding_window


def test_decoder_forward_matches(served):
    name, _, jcfg, params = served
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 33)).astype(np.int32)
    jm = JaxDecoderLM(jcfg, attn_impl="pallas")
    want, _ = jm.forward(params, jnp.asarray(tokens))
    got = decoder_from_jax(PORT_CFGS[name], jax.device_get(params), "cpu")(
        torch.tensor(tokens).long())
    _close(got, want)


class TestAttentionApply:
    """One layer of the GQA 4/2 head_dim-120 variant (window 64)."""

    jcfg, tcfg = JAX_CFGS["h2o-gqa4/2-dh120"], PORT_CFGS["h2o-gqa4/2-dh120"]

    @pytest.fixture(scope="class")
    def layer(self):
        defs = jax_attn.attention_defs(self.jcfg)
        rng = np.random.default_rng(4)
        p = {n: (rng.standard_normal(d.shape) / np.sqrt(d.fan_in)).astype(np.float32)
             for n, d in defs.items()}
        return {n: jnp.asarray(a) for n, a in p.items()}, params_from_jax(p, "cpu")

    def _x(self, s, seed):
        return np.random.default_rng(seed).standard_normal((2, s, self.jcfg.d_model)).astype(
            np.float32)

    @pytest.mark.parametrize("impl", ["kernel", "dense"])
    def test_no_cache(self, layer, impl):
        jp, tp = layer
        x = self._x(70, 5)
        pos = np.broadcast_to(np.arange(70), (2, 70))
        want, _ = jax_attn.attention_apply(jp, jnp.asarray(x), self.jcfg, positions=jnp.asarray(pos),
                                           impl="pallas" if impl == "kernel" else "dense")
        got, cache = attention.attention_apply(tp, torch.tensor(x), self.tcfg,
                                               positions=torch.tensor(pos), impl=impl)
        assert cache is None
        _close(got, want)

    def test_prefill_into_ring_then_decode_past_the_wrap(self, layer):
        jp, tp = layer
        s = 100                                    # > window 64: the ring keeps the last 64
        x = self._x(s, 6)
        pos = np.broadcast_to(np.arange(s), (2, s))
        jc = jax_attn.init_kv_cache(self.jcfg, 2, 128, jnp.float32)
        tc = attention.init_kv_cache(self.tcfg, 2, 128, torch.float32, "cpu")
        want, jc = jax_attn.attention_apply(jp, jnp.asarray(x), self.jcfg, positions=jnp.asarray(pos),
                                            cache=jc, impl="pallas")
        got, tc = attention.attention_apply(tp, torch.tensor(x), self.tcfg,
                                            positions=torch.tensor(pos), cache=tc)
        _close(got, want)
        for t in range(s, s + 30):                 # slots t % 64 wrap at t = 128
            xt = self._x(1, t)
            want, jc = jax_attn.attention_apply(
                jp, jnp.asarray(xt), self.jcfg, positions=jnp.full((2, 1), t, jnp.int32),
                cache=jc, decode_pos=jnp.int32(t), impl="pallas")
            got, tc = attention.attention_apply(
                tp, torch.tensor(xt), self.tcfg, positions=torch.full((2, 1), t), cache=tc,
                decode_pos=t)
            _close(got, want)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        np.testing.assert_array_equal(_np(tc["slot_pos"]), np.asarray(jc["slot_pos"]))

    def test_unported_paths_raise(self, layer):
        _, tp = layer
        x = torch.tensor(self._x(3, 9)[:1])
        pos = torch.arange(3)[None]
        jp, _ = layer
        for impl in ("xla_flash", "chunked"):     # ported: the JAX package's paths
            want, _ = jax_attn.attention_apply(jp, jnp.asarray(x.numpy()), self.jcfg,
                                               positions=jnp.asarray(pos.numpy()), impl=impl)
            got, _ = attention.attention_apply(tp, x, self.tcfg, positions=pos, impl=impl)
            _close(got, want)
        with pytest.raises(ValueError, match="unknown attention impl"):
            attention.attention_apply(tp, x, self.tcfg, positions=pos, impl="pallas")
        # cross-attention is ported now: the given K and V, the plain path whatever impl is
        hkv, dh = self.tcfg.num_kv_heads, self.tcfg.resolved_head_dim
        kv = np.random.default_rng(9).standard_normal((2, 1, 11, hkv, dh)).astype(np.float32)
        want, _ = jax_attn.attention_apply(jp, jnp.asarray(x.numpy()), self.jcfg,
                                           positions=jnp.asarray(pos.numpy()),
                                           cross_kv=tuple(jnp.asarray(a) for a in kv),
                                           impl="pallas")
        got, cache = attention.attention_apply(tp, x, self.tcfg, positions=pos,
                                               cross_kv=tuple(torch.tensor(a) for a in kv))
        assert cache is None
        _close(got, want)
        capped = dataclasses.replace(self.tcfg, attn_logit_softcap=30.0)
        with pytest.raises(NotImplementedError, match="softcap"):
            attention.attention_apply(tp, x, capped, positions=pos)
        # the plain path keeps the softcap, as the JAX package's dense path does
        jcapped = dataclasses.replace(self.jcfg, attn_logit_softcap=30.0)
        want, _ = jax_attn.attention_apply(jp, jnp.asarray(x.numpy()), jcapped,
                                           positions=jnp.asarray(pos.numpy()), impl="dense")
        got, _ = attention.attention_apply(tp, x, capped, positions=pos, impl="dense")
        _close(got, want)
