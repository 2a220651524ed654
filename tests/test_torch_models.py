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
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

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
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_tc_ref  # noqa: E402
from repro_torch.models import DecoderLM, attention, common, mlp  # noqa: E402

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


def _simt_order(q, k, v, *, causal=True, window=None):
    """The SIMT kernel's order of float32 sums on the CPU: 64-key tiles,
    online softmax, p in float32."""
    return attention_tc_ref(q.float(), k.float(), v.float(), causal=causal, window=window,
                            block_k=64).to(q.dtype)


@pytest.fixture(scope="module")
def bf16_serve():
    """chip_smoke.py, and a 24-layer bf16 h2o-danube-3-4b at d_model 512
    (window 64) with its prefill logits through the dense path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(configs.get_config("h2o-danube-3-4b"), d_model=512, num_heads=8,
                              num_kv_heads=2, head_dim=120, d_ff=2048, vocab_size=4000,
                              sliding_window=64)
    model = DecoderLM(cfg, dtype=torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    model.attn_impl = "dense"
    plain, _ = model.prefill(tokens, model.init_cache(2, 256))
    model.attn_impl = "kernel"
    return chip_smoke, model, tokens, plain


def _drift(model, tokens, plain, capsys, label):
    """chip_smoke.py's two ratios for the prefill logits of ``model`` against
    ``plain``, the dense path's; printed (run with -s to see them)."""
    tiled, _ = model.prefill(tokens, model.init_cache(*tokens.shape))
    d = (tiled.float() - plain.float()).abs()
    max_rel = float(d.max() / plain.float().abs().max())
    mean_rel = float(d.mean() / plain.float().std())
    with capsys.disabled():
        print(f"\n{label} over {model.cfg.num_layers} layers: max {max_rel:.4g} of "
              f"max|logit|, mean {mean_rel:.4g} of the std")
    return max_rel, mean_rel


def _serve_drift(bf16_serve, monkeypatch, attend, capsys, label):
    """The two ratios for the logits of ``attend`` in place of the kernel."""
    _, model, tokens, plain = bf16_serve
    monkeypatch.setattr(attention, "flash_attention", attend)
    return _drift(model, tokens, plain, capsys, label)


@pytest.mark.parametrize("order", ["simt", "tensor-core"])
def test_bf16_drift_between_attention_orders_is_within_the_serve_bounds(bf16_serve, monkeypatch,
                                                                        capsys, order):
    """The bound of chip_smoke.py's full-width serve check, from the CPU: at
    full depth in bf16, the dense path against each kernel's order (the SIMT
    kernel's float32 tiles; the tensor-core kernel's 128-key tiles with p
    rounded to bf16) moves the prefill logits only by bf16 rounding carried
    through 24 layers."""
    chip_smoke = bf16_serve[0]
    attend = _simt_order if order == "simt" else attention_tc_ref
    max_rel, mean_rel = _serve_drift(bf16_serve, monkeypatch, attend, capsys,
                                     f"bf16 drift, {order} order")
    assert 0 < max_rel < chip_smoke.SERVE_MAX_ERR and mean_rel < chip_smoke.SERVE_MEAN_ERR


@pytest.mark.parametrize("fault", ["window dropped", "window one too wide", "causal off"])
def test_a_planted_mask_fault_fails_the_serve_bounds(bf16_serve, monkeypatch, capsys, fault):
    """The same check with a wrong mask planted in the kernel's tile order:
    at this width (a 64-key window) each fault moves the logits beyond both
    bounds.  At full width chip_smoke.py reads the dropped window too."""
    def attend(q, k, v, *, causal, window):
        if fault == "window dropped":
            window = None
        elif fault == "window one too wide":
            window += 1
        else:
            causal = False
        return _simt_order(q, k, v, causal=causal, window=window)

    chip_smoke = bf16_serve[0]
    max_rel, mean_rel = _serve_drift(bf16_serve, monkeypatch, attend, capsys, fault)
    assert max_rel > chip_smoke.SERVE_MAX_ERR and mean_rel > chip_smoke.SERVE_MEAN_ERR


@pytest.fixture(scope="module")
def bf16_gemma():
    """chip_smoke.py, and an 18-layer bf16 gemma-2b at d_model 512 with its
    head_dim of 256 (2 query heads, MQA, GeGLU, tied embeddings) and its
    prefill logits through the dense path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(configs.get_config("gemma-2b"), d_model=512, num_heads=2,
                              num_kv_heads=1, head_dim=256, d_ff=2048, vocab_size=4000)
    model = DecoderLM(cfg, dtype=torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    model.attn_impl = "dense"
    plain, _ = model.prefill(tokens, model.init_cache(2, 256))
    model.attn_impl = "kernel"
    return chip_smoke, model, tokens, plain


def test_bf16_drift_of_the_wide_tensor_core_order_is_within_the_gemma_serve_bounds(
        bf16_gemma, monkeypatch, capsys):
    """The bound of chip_smoke.py's serve-gemma check (phase 8), from the CPU:
    at gemma-2b's depth and head_dim in bf16, the dense path against the
    tensor-core kernel's order at Dh 256 (64-key tiles, p rounded to bf16)."""
    from repro_torch.kernels.flash_attention import ops
    chip_smoke, model, tokens, plain = bf16_gemma
    block_k = ops.tc_block_k(model.cfg.head_dim)
    assert block_k == 64
    monkeypatch.setattr(attention, "flash_attention",
                        functools.partial(attention_tc_ref, block_k=block_k))
    max_rel, mean_rel = _drift(model, tokens, plain, capsys, "bf16 drift, Dh-256 tc order")
    assert 0 < max_rel < chip_smoke.SERVE_MAX_ERR and mean_rel < chip_smoke.SERVE_MEAN_ERR


@pytest.mark.parametrize("fault", ["window of half the prompt", "causal off"])
def test_a_planted_mask_fault_fails_the_gemma_serve_bounds(bf16_gemma, monkeypatch, capsys,
                                                            fault):
    """The plain path with a wrong mask against the right one: chip_smoke.py
    plants the first at full width (a window of 4096 over an 8176-token
    prompt, ``GEMMA_FAULT_WINDOW``) and fails if the bounds do not see it."""
    chip_smoke, model, tokens, plain = bf16_gemma
    monkeypatch.setattr(model, "attn_impl", "dense")
    if fault == "causal off":
        def attend(q, k, v, *, causal, window, softcap_val=None):
            return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=False, window=window).transpose(1, 2)
        monkeypatch.setattr(attention, "dense_attention", attend)
    else:
        monkeypatch.setattr(model, "cfg", dataclasses.replace(
            model.cfg, sliding_window=tokens.shape[1] * chip_smoke.GEMMA_FAULT_WINDOW
            // chip_smoke.GEMMA_PROMPT))
    max_rel, mean_rel = _drift(model, tokens, plain, capsys, fault)
    assert max_rel > chip_smoke.SERVE_MAX_ERR and mean_rel > chip_smoke.SERVE_MEAN_ERR


@pytest.fixture(scope="module")
def f32_serve():
    """chip_smoke.py, and the bf16 fixture's h2o-danube-3-4b at d_model 512
    and its depth of 24 layers, in float32 (the models' default dtype), with
    its prefill logits through the dense path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(configs.get_config("h2o-danube-3-4b"), d_model=512, num_heads=8,
                              num_kv_heads=2, head_dim=120, d_ff=2048, vocab_size=4000,
                              sliding_window=64)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))
    model.attn_impl = "dense"
    plain, _ = model.prefill(tokens, model.init_cache(2, 256))
    model.attn_impl = "kernel"
    return chip_smoke, model, tokens, plain


def test_f32_drift_of_the_3xtf32_order_is_within_the_f32_serve_bounds(f32_serve, monkeypatch,
                                                                      capsys):
    """The bound of chip_smoke.py's serve-f32 check (phase 9), from the CPU: in
    float32 over 24 layers, the dense path against the float32 tensor-core
    kernel's order (3xTF32 products at its 64-key tile) moves the prefill
    logits only by float32 rounding."""
    from repro_torch.kernels.flash_attention import ops
    chip_smoke, model, tokens, plain = f32_serve
    monkeypatch.setattr(attention, "flash_attention", functools.partial(
        attention_tc_ref, block_k=ops.f32_block_k(model.cfg.head_dim), products="3xtf32"))
    max_rel, mean_rel = _drift(model, tokens, plain, capsys, "f32 drift, 3xTF32 order")
    assert 0 < max_rel < chip_smoke.SERVE_F32_MAX_ERR
    assert mean_rel < chip_smoke.SERVE_F32_MEAN_ERR


def test_a_dropped_window_fails_the_f32_serve_bounds(f32_serve, monkeypatch, capsys):
    """The plain path with the window dropped against the right one, in
    float32: chip_smoke.py plants it at full width in phase 9 and fails if
    the bounds do not see it."""
    chip_smoke, model, tokens, plain = f32_serve
    monkeypatch.setattr(model, "attn_impl", "dense")
    monkeypatch.setattr(model, "cfg", dataclasses.replace(model.cfg, sliding_window=None))
    max_rel, mean_rel = _drift(model, tokens, plain, capsys, "f32, window dropped")
    assert max_rel > chip_smoke.SERVE_F32_MAX_ERR and mean_rel > chip_smoke.SERVE_F32_MEAN_ERR
