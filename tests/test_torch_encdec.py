"""Whisper's encoder-decoder in the port against the JAX package's, on the CPU.

``reduced(whisper-large-v3)`` (2 encoder + 2 decoder layers, d_model 256, 2
heads of 64, vocab 512), the JAX parameters carried across by
``encdec_from_jax``; every leaf, the biases and layer-norm weights included
(zero at ``init``), is drawn from a seed so that each does something.  Each
case makes its inputs with numpy from a seed:

* ``layer_norm`` and the sinusoidal tables against the JAX package's;
* ``encode`` on every path: JAX's ``pallas`` (its Pallas kernel in interpret
  mode) against the port's ``kernel`` path (the kernel's plain version on the
  CPU), ``dense``, ``xla_flash`` and ``chunked`` against their JAX twins, at
  rtol 1e-5 / atol 1e-5;
* cross-attention with qk-norm on (only q normed, the keys' norm weight
  unread), one-token and longer, the full ``decode`` logits and ``loss`` at
  ``DEEP_TOL`` (rtol 1e-5 / atol 3e-5);
* a cached prefill, then decode steps, against JAX's steps and the full
  forward; ``ServeEngine(is_encdec=True)``'s two steps give the JAX engine's
  greedy tokens (JAX on its default xla_flash path there, jitted);
* one ``FederatedTrainer`` round with frames against the JAX package's
  ``train_step``, fed JAX's own ``_tree_noise`` draws through ``TrainNoise``
  (tolerances of tests/test_torch_train.py);
* the parameter layout: ``trainer_params_to_jax`` gives back JAX's tree, and
  a checkpoint the port writes the JAX package loads; ``count_params``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import compose as jcomp  # noqa: E402
from repro.launch.rules import count_params as jax_count  # noqa: E402
from repro.launch.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.launch.train import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.launch.train import _tree_noise  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.encdec import EncDecLM as JaxEncDecLM  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_from_jax,
    trainer_params_from_jax,
    trainer_params_to_jax,
)
from repro_torch.launch import FederatedTrainer, ServeEngine, TrainNoise, count_params  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM, attention, build_model, common  # noqa: E402

WHISPER = "whisper-large-v3"
TOL = dict(rtol=1e-5, atol=1e-5)
DEEP_TOL = dict(rtol=1e-5, atol=3e-5)   # downstream of the first layer
B, T, S = 2, 40, 12                     # utterances, frames, decoder tokens
RTOL = 1e-5                             # tests/test_torch_train.py's float32 tolerance
K, TAU = 2, 1
FED = dict(local_steps=TAU, local_lr=0.05, clip_norm=0.3, noise_sigma=1e-4)


def cfgs(**changes):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(WHISPER)), **changes)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(WHISPER)), **changes)
    return jcfg, cfg


_PARAMS = {}


def jax_params(**changes):
    """A params tree of the JAX package's ``EncDecLM`` of the reduced config
    (its ``init``'s structure), every leaf, the biases and norms included,
    drawn N(0, 0.05^2) with numpy (cached)."""
    key = tuple(sorted(changes.items()))
    if key not in _PARAMS:
        jcfg, _ = cfgs(**changes)
        shapes = jax.eval_shape(JaxEncDecLM(jcfg).init, jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        _PARAMS[key] = jax.tree_util.tree_map(
            lambda a: (0.05 * rng.standard_normal(a.shape)).astype(a.dtype), shapes)
    return _PARAMS[key]


def port_model(impl="xla_flash", **changes):
    _, cfg = cfgs(**changes)
    model = encdec_from_jax(cfg, jax_params(**changes), "cpu")
    model.attn_impl = impl
    return model


def inputs(seed=0, b=B, t=T, s=S):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, t, 256)).astype(np.float32)
    toks = rng.integers(0, 512, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :2] = -1                     # ignored positions
    return frames, toks[:, :-1], labels


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# layer_norm, sinusoidal positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x, scale, bias = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((4, 7, 256), (256,), (256,)))
    x = 3.0 + 2.0 * x                      # an offset and a spread for the norm to remove
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_common.layer_norm(*(jnp.asarray(a, jd) for a in (x, 0.1 * scale, bias)), 1e-6)
    got = common.layer_norm(*(torch.tensor(a).to(td) for a in (x, 0.1 * scale, bias)), 1e-6)
    assert got.dtype == td
    if dtype == "float32":
        close(got, want)
    else:   # both compute in float32 from the same bf16 inputs; the outputs within one ulp
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2**-8, atol=1e-6)
    # a zero scale is the identity scale, as in the JAX package
    zero = common.layer_norm(torch.tensor(x), torch.zeros(256), torch.zeros(256))
    xs = (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(zero.numpy(), xs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("length,dim", [(1500, 1280), (448, 1280), (448, 256)])
def test_sinusoidal_tables_match_jax(length, dim):
    """Both tables are computed in float32 and then cast.  The float32 tables
    differ only by the two packages' exp and sin in float32 (a last-bit
    difference of a frequency grows with the position), and the bf16 tables
    are the float32 ones rounded: within one bf16 ulp (2^-7 relative) and the
    float32 tables' gap of JAX's, and equal to them almost everywhere."""
    want = np.asarray(jax_common.sinusoidal_positions(length, dim, jnp.float32))
    got = common.sinusoidal_positions(length, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.numpy()[:16], want[:16], rtol=0, atol=4e-6)
    bf = common.sinusoidal_positions(length, dim, torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))
    jbf = np.asarray(jax_common.sinusoidal_positions(length, dim, jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_allclose(bf.float().numpy(), jbf, rtol=2**-7, atol=2e-4)
    assert np.mean(bf.float().numpy() == jbf) > 0.99


# ---------------------------------------------------------------------------
# encode, cross-attention, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_impl,impl", [("pallas", "kernel"), ("dense", "dense"),
                                           ("xla_flash", "xla_flash"), ("chunked", "chunked")])
def test_encode_matches_jax_on_every_path(jax_impl, impl):
    jcfg, _ = cfgs()
    frames, _, _ = inputs()
    want = JaxEncDecLM(jcfg, attn_impl=jax_impl).encode(jax_params(), jnp.asarray(frames))
    model = port_model(impl)
    got = model.encode(torch.tensor(frames))
    assert got.shape == (B, T, 256)
    close(got, want)


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("jax_impl,impl", [("dense", "dense"), ("pallas", "kernel")])
def test_cross_attention_with_qk_norm_matches_jax(s, jax_impl, impl):
    """Only q is qk-normed; the keys' norm weight is not read; no RoPE; the
    plain paths whatever impl is (dense for a one-token step)."""
    jcfg, cfg = cfgs(qk_norm=True)
    rng = np.random.default_rng(4)
    defs = attention.attention_defs(cfg, "xattn_")
    params = {n: (0.3 * rng.standard_normal(p.shape) / math.sqrt(p.fan_in)
                  + (1.0 if n.endswith("norm") else 0.0) * rng.standard_normal(p.shape))
              .astype(np.float32) for n, p in defs.items()}
    assert {"xattn_qnorm", "xattn_knorm", "xattn_wq_b", "xattn_wv_b"} <= set(params)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    kv = tuple(rng.standard_normal((B, T, cfg.num_kv_heads, 64)).astype(np.float32)
               for _ in range(2))
    pos = np.broadcast_to(np.arange(s), (B, s))
    want, _ = jax_attn.attention_apply({n: jnp.asarray(a) for n, a in params.items()},
                                       jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                       cross_kv=tuple(map(jnp.asarray, kv)), impl=jax_impl,
                                       prefix="xattn_")
    tp = {n: torch.tensor(a) for n, a in params.items()}
    got, cache = attention.attention_apply(tp, torch.tensor(x), cfg,
                                           positions=torch.tensor(pos),
                                           cross_kv=tuple(map(torch.tensor, kv)), impl=impl,
                                           prefix="xattn_")
    assert cache is None
    close(got, want, DEEP_TOL)
    tp["xattn_knorm"] = tp["xattn_knorm"] + 5.0
    again, _ = attention.attention_apply(tp, torch.tensor(x), cfg, positions=torch.tensor(pos),
                                         cross_kv=tuple(map(torch.tensor, kv)), impl=impl,
                                         prefix="xattn_")
    assert torch.equal(again, got)


@pytest.mark.parametrize("jax_impl,impl", [("xla_flash", "xla_flash"), ("pallas", "kernel")])
def test_decode_logits_and_loss_match_jax(jax_impl, impl):
    jcfg, _ = cfgs()
    frames, toks, labels = inputs(1)
    jm = JaxEncDecLM(jcfg, attn_impl=jax_impl, remat=False)
    jp = jax_params()
    enc = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    want, _ = jax.jit(jm.decode)(jp, jnp.asarray(toks), enc)
    model = port_model(impl)
    got, caches = model.decode(torch.tensor(toks), model.encode(torch.tensor(frames)))
    assert caches is None and got.shape == (B, S, 512)
    close(got, want, DEEP_TOL)
    wloss = jax.jit(jm.loss)(jp, jnp.asarray(frames), jnp.asarray(toks), jnp.asarray(labels))
    params = {n: p.detach() for n, p in model.named_parameters()}
    with torch.no_grad():
        loss = model.loss(params, torch.tensor(frames), torch.tensor(toks), torch.tensor(labels))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)


def test_qk_norm_stack_loss_matches_jax_and_remat_changes_no_gradient_bit():
    """A whisper stack with qk-norm on (the cross-attention keys un-normed)
    through xla_flash: the loss at rtol 1e-5; remat on = remat off in bits for
    every gradient; the cross-attention key norm is never read (no gradient)."""
    jcfg, _ = cfgs(qk_norm=True)
    frames, toks, labels = inputs(2)
    wloss = jax.jit(JaxEncDecLM(jcfg, attn_impl="xla_flash", remat=False).loss)(
        jax_params(qk_norm=True), jnp.asarray(frames), jnp.asarray(toks), jnp.asarray(labels))
    model = port_model("xla_flash", qk_norm=True)
    grads = {}
    for remat in (True, False):
        model.remat = remat
        leaves = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
        loss = model.loss(leaves, torch.tensor(frames), torch.tensor(toks),
                          torch.tensor(labels))
        grads[remat] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                             allow_unused=True)))
        np.testing.assert_allclose(float(loss.detach()), float(wloss), rtol=1e-5)
    unread = {n for n, g in grads[True].items() if g is None}
    assert unread == {f"dec_blocks.{i}.xattn_knorm" for i in range(2)}
    for n, g in grads[True].items():
        assert n in unread or torch.equal(g, grads[False][n]), n


def test_prefill_then_decode_steps_match_jax_and_the_full_forward():
    """The JAX steps on its default path (xla_flash), the port's on the
    kernel path (the kernel's plain version on the CPU)."""
    jcfg, _ = cfgs()
    frames, toks, _ = inputs(5)
    jm = JaxEncDecLM(jcfg, remat=False)
    jp = jax_params()
    enc = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    decode, decode_step = jax.jit(jm.decode), jax.jit(jm.decode_step)
    full, _ = decode(jp, jnp.asarray(toks), enc)
    model = port_model("kernel")
    tenc = model.encode(torch.tensor(frames))
    tfull, _ = model.decode(torch.tensor(toks), tenc)
    split = S // 2
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    jlog, jc = decode(jp, jnp.asarray(toks[:, :split]), enc, caches=jc)
    caches = model.init_cache(B, S)
    assert len(caches["blocks"]) == 2
    logits, caches = model.decode(torch.tensor(toks[:, :split]), tenc, caches=caches)
    close(logits, jlog, DEEP_TOL)
    close(logits, tfull[:, :split], DEEP_TOL)
    assert bool((caches["blocks"][0]["slot_pos"][:split] == torch.arange(split)).all())
    for t in range(split, S):
        jstep, jc = decode_step(jp, jnp.asarray(toks[:, t]), jnp.int32(t), enc, jc)
        step, caches = model.decode_step(torch.tensor(toks[:, t]), t, tenc, caches)
        close(step, jstep, DEEP_TOL)
        close(step, tfull[:, t], DEEP_TOL)
        close(step, full[:, t], DEEP_TOL)


def test_serve_engine_steps_give_the_jax_engines_tokens():
    jcfg, _ = cfgs()
    frames, toks, _ = inputs(6, s=4)
    new = 6
    jm = JaxEncDecLM(jcfg, remat=False)
    jp = jax_params()
    jeng = JaxServeEngine(jm, is_encdec=True)
    jtok, jc, jenc = jax.jit(jeng.make_prefill_step())(
        jp, jnp.asarray(frames), jnp.asarray(toks), jm.init_cache(B, 4 + new, dtype=jnp.float32))
    want = [np.asarray(jtok)]
    jdecode = jax.jit(jeng.make_decode_step())
    for pos in range(4, 4 + new - 1):
        jtok, _, jc = jdecode(jp, jtok, jnp.int32(pos), jc, jenc)
        want.append(np.asarray(jtok))
    model = port_model("kernel")
    eng = ServeEngine(model, is_encdec=True)
    tok, caches, enc = eng.make_prefill_step()(torch.tensor(frames), torch.tensor(toks),
                                               model.init_cache(B, 4 + new))
    close(enc, jenc)
    got = [tok.numpy()]
    decode = eng.make_decode_step()
    for pos in range(4, 4 + new - 1):
        tok, logits, caches = decode(tok, pos, caches, enc)
        assert logits.shape == (B, 512)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    for engine in (eng, ServeEngine(model)):
        with pytest.raises(NotImplementedError, match="make_prefill_step"):
            engine.generate(torch.tensor(toks), 2, 8)


# ---------------------------------------------------------------------------
# one FederatedTrainer round with frames
# ---------------------------------------------------------------------------

def jax_round_noise(jtrainer, jp, key, k):
    """The JAX round's noise as the port's TrainNoise (tests/test_torch_train.py's
    helper): ``_tree_noise`` of the mechanism's key, and xi."""
    alg = jtrainer.server_algorithm(k)
    k_mech, extra = alg._split_keys(key)
    mech, noise = alg.mechanism, TrainNoise()
    if isinstance(mech, jcomp.GaussianLDP):
        tmpl = jax.tree_util.tree_map(lambda l: jnp.zeros((k,) + l.shape, l.dtype), jp)
        tree = jax.device_get(jax.jit(_tree_noise)(k_mech, tmpl, mech.sigma))
        per = [trainer_params_from_jax(jax.tree_util.tree_map(lambda l: l[i], tree), "cpu")
               for i in range(k)]
        noise.tree = {n: torch.stack([p[n] for p in per]) for n in per[0]}
    elif isinstance(mech, jcomp.CentralGaussian):
        std = mech.sigma / math.sqrt(mech.num_clients)
        noise.tree = trainer_params_from_jax(
            jax.device_get(jax.jit(_tree_noise)(k_mech, jp, std)), "cpu")
    if extra and alg.step.uses_extrapolation and mech.needs_xi_key:
        noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
    return noise


@pytest.mark.parametrize("name", ["cdp-fedexp"])
def test_one_training_round_with_frames_matches_jax(name):
    jcfg, cfg = cfgs()
    jp = jax_params()
    jm = JaxEncDecLM(jcfg, attn_impl="xla_flash", remat=False)   # remat changes no value
    n = jax_count(jm)
    assert n == count_params(cfg)
    rng = np.random.default_rng(8)
    frames = rng.standard_normal((K, TAU, 1, T, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (K, TAU, 1, S + 1)).astype(np.int32)
    batch = dict(frames=frames, tokens=toks[..., :-1], labels=toks[..., 1:])
    jtrainer = JaxTrainer(jm, jconfigs.FederatedConfig(algorithm=name, **FED), n)
    key = jax.random.PRNGKey(7)
    jnew, jmet = jax.jit(jtrainer.make_train_step(K))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    model = build_model(cfg, attn_impl="xla_flash", device="cpu")
    assert isinstance(model, EncDecLM)
    trainer = FederatedTrainer(model, configs.FederatedConfig(algorithm=name, **FED), n)
    old = trainer_params_from_jax(jp, "cpu")
    assert set(old) == {k for k, _ in model.named_parameters()}
    new, met = trainer.make_train_step(K)(
        old, {k: torch.tensor(v) for k, v in batch.items()}, torch.Generator().manual_seed(0),
        noise=jax_round_noise(jtrainer, jp, key, K))
    for k in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=RTOL, err_msg=k)
    assert float(met["eta_g"]) > 1.05, "the test must exercise the extrapolation"
    assert bool((met["client_norms"] > FED["clip_norm"]).all()), "the test must exercise the clip"
    jnew = trainer_params_from_jax(jax.device_get(jnew), "cpu")
    scale = max(float((jnew[k] - old[k]).abs().max()) for k in new)
    for k in new:
        want = np.asarray(jnew[k], np.float64)
        np.testing.assert_allclose(np.asarray(new[k], np.float64), want, rtol=RTOL,
                                   atol=RTOL * max(np.abs(want).max(), 1e-30), err_msg=k)
        err = float(((new[k] - old[k]) - (jnew[k] - old[k])).abs().max())
        assert err <= RTOL * scale, f"update of {k} off by {err} (scale {scale})"
    assert not torch.equal(new["enc_blocks.0.attn_wq"], old["enc_blocks.0.attn_wq"])
    assert not torch.equal(new["dec_blocks.1.xattn_wk"], old["dec_blocks.1.xattn_wk"])


# ---------------------------------------------------------------------------
# parameter layout, counts, refusals
# ---------------------------------------------------------------------------

def test_trainer_params_round_trip_and_the_jax_package_loads_the_checkpoint(tmp_path):
    jcfg, cfg = cfgs()
    jp = jax_params()
    params = trainer_params_from_jax(jp, "cpu")
    assert "enc_blocks.1.mlp_wi" in params and "dec_blocks.0.xattn_wo_b" in params
    back = trainer_params_to_jax(params)
    assert "blocks" not in back
    flat, got = (jax.tree_util.tree_leaves_with_path(t) for t in (jp, back))
    assert [p for p, _ in flat] == [p for p, _ in got]
    for (_, a), (_, b) in zip(flat, got):
        np.testing.assert_array_equal(np.asarray(a), b)
    ckpt.save_checkpoint(str(tmp_path), 3, back, {"algorithm": "cdp-fedexp"})
    template = jax.tree_util.tree_map(   # the structure of init's tree, in bf16
        lambda a: jnp.zeros(a.shape, jnp.bfloat16),
        jax.eval_shape(JaxEncDecLM(jcfg, dtype=jnp.bfloat16).init, jax.random.PRNGKey(1)))
    loaded, meta = jckpt.load_checkpoint(str(tmp_path), template)
    assert meta["step"] == 3
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(loaded), flat):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a), np.asarray(jnp.asarray(b, jnp.bfloat16)))
    model = encdec_from_jax(cfg, jp, "cpu")
    assert all(torch.equal(p, params[n]) for n, p in model.named_parameters())


def test_encdec_from_jax_checks_names_and_depths():
    _, cfg = cfgs()
    jp = jax_params()
    with pytest.raises(ValueError, match="layers stacked"):
        encdec_from_jax(dataclasses.replace(cfg, num_encoder_layers=3), jp, "cpu")
    with pytest.raises(ValueError, match="layers stacked"):
        encdec_from_jax(dataclasses.replace(cfg, num_layers=1), jp, "cpu")
    with pytest.raises(ValueError, match="parameter names"):
        encdec_from_jax(cfg, {**jp, "head": jp["embed"]}, "cpu")
    bad = {**jp, "dec_blocks": {k: v for k, v in jp["dec_blocks"].items() if k != "xattn_wk"}}
    with pytest.raises(ValueError, match="dec_blocks parameters"):
        encdec_from_jax(cfg, bad, "cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_of_whisper_matches_jax(reduced):
    jcfg, cfg = cfgs() if reduced else (jconfigs.get_config(WHISPER), configs.get_config(WHISPER))
    want = jax_count(JaxEncDecLM(jcfg))
    assert count_params(cfg) == want
    if not reduced:
        assert want == 1_535_587_840
    else:
        assert count_params(EncDecLM(cfg, device="cpu")) == want


def test_build_model_and_the_refusals():
    _, cfg = cfgs()
    dense = configs.reduced(configs.get_config("h2o-danube-3-4b"))
    assert isinstance(build_model(dense, device="cpu"), DecoderLM)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, EncDecLM) and model.attn_impl == "kernel"
    assert len(model.enc_blocks) == cfg.num_encoder_layers and len(model.dec_blocks) == 2
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.1)
    assert not model.enc_norm.any() and not model.dec_blocks[0]["xattn_wv_b"].any()
    with pytest.raises(ValueError, match="DecoderLM"):
        EncDecLM(dense, device="cpu")
    with pytest.raises(NotImplementedError, match="EncDecLM"):
        DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown attention impl"):
        EncDecLM(cfg, device="cpu", attn_impl="pallas")
    frames, toks, labels = inputs()
    params = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
    with pytest.raises(NotImplementedError, match="no backward"):
        model.loss(params, torch.tensor(frames), torch.tensor(toks), torch.tensor(labels))
    with pytest.raises(ValueError, match="missing"), torch.no_grad():
        model.loss({"embed": params["embed"]}, torch.tensor(frames), torch.tensor(toks),
                   torch.tensor(labels))
    with pytest.raises(ValueError, match="kernel"):
        FederatedTrainer(model, configs.FederatedConfig(algorithm="cdp-fedexp"), 1)
