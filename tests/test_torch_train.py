"""Federated LM training in the port against the JAX package's, on the CPU.

``DecoderLM.loss`` and its gradients on reduced h2o-danube-3-4b, gemma-2b,
granite-8b, command-r-plus-104b and mamba2-2.7b (two layers, d_model 128),
labels of -1 and a sequence that is not a multiple of ``loss_chunk``, on
every plain attention path; remat (and the "dots" policy) against no remat
in bits; the chunked SSD's gradient where the JAX package's is NaN;
``clip_tree``; ``count_params`` for every configuration at full size
(whisper's enc-dec included); one ``FederatedTrainer`` train_step of
fedavg, fedexp, dp-fedavg-ldp-gauss, ldp-fedexp-gauss, dp-fedavg-cdp and cdp-fedexp against
the JAX package's jitted ``train_step``, the port fed the JAX round's own
noise (``_tree_noise`` of its key splits, and its xi); the same in bf16; the
port's own draws materialized (``draw_noise``) against the step's; the
refusals; and ``examples/train_federated_lm_torch.py`` on the CPU for 2
rounds, whose checkpoint the JAX package's ``DecoderLM`` loads.

Tolerances.  Float32: a scalar at rtol 1e-5; an array at rtol 1e-5 with an
atol of 1e-5 times its largest entry (both packages sum the same products in
float32, in other orders).  The step's update tree (new - old parameters) is
held at 1e-5 of its largest entry over the whole tree: a leaf whose update is
small against its values loses digits in p_tau - p in both packages alike.
The chunked SSD's gradient against the step-by-step recurrence's: rtol 1e-4
with an atol of 1e-4 times the largest entry (two float32 algorithms, 256
steps).  A Mamba2 round (two local steps, the second from parameters already
off in their last bits, through the SSD's chained exp and cumsum and the
tied embedding's scatter-add over tokens) at 1e-4 for the parameters and the
update tree: measured 3.6e-5 of a leaf's update, 2.9e-5 of the tree's
(``-s`` prints them); its loss and metrics at 1e-5.  bf16: both packages round every leaf of a local
step's p - eta_l g to bf16, and XLA fuses elementwise chains in float32 where
PyTorch rounds after each op, so the gradients differ in bf16 digits and a
parameter's rounding can go either way.  The update p_tau - p is then a few
bf16 ulps of p (ulp(p) is of the order of eta_l g here) and differs by about
one: measured 3.6-5.0% of the update tree in L2, up to 17% on a leaf
(``-s`` prints them).  So:
each new parameter within one bf16 ulp of its value (2^-7 |p|) plus the
round's largest update, the update tree within 10% in L2, the loss (before
any update) at 1e-4, eta_g at 1e-3, the update norms and ||cbar||^2 at 1e-2.
"""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import compose as jcomp  # noqa: E402
from repro.core.clipping import clip_tree as jax_clip_tree  # noqa: E402
from repro.launch.rules import count_params as jax_count  # noqa: E402
from repro.launch.rules import is_giant as jax_is_giant  # noqa: E402
from repro.launch.train import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.launch.train import _tree_noise  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.models.encdec import EncDecLM as JaxEncDecLM  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    trainer_params_from_jax,
    trainer_params_to_jax,
)
from repro_torch.core.clipping import clip_tree  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    GIANT_PARAM_THRESHOLD,
    FederatedTrainer,
    TrainNoise,
    count_params,
    is_giant,
)
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
ARCHS = ("h2o-danube-3-4b", "gemma-2b", "granite-8b", "command-r-plus-104b", "mamba2-2.7b")
LOSS_CHUNK = 16
B, S = 2, 45                       # 45 positions: two whole loss chunks and a padded one
K, TAU = 2, 2
NAMES = ("fedavg", "fedexp", "dp-fedavg-ldp-gauss", "ldp-fedexp-gauss", "dp-fedavg-cdp",
         "cdp-fedexp")
# clip 0.5 binds (the updates' norms are near 1); sigma 1e-4 leaves FedEXP room
# to extrapolate at d ~ 4e5 (d sigma^2 / K well below ||cbar||^2)
FED = dict(local_steps=TAU, local_lr=0.05, clip_norm=0.5, noise_sigma=1e-4)
MAMBA2_RTOL = 1e-4     # a Mamba2 round's update: the docstring says why


def close_vec(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def close(got, want, rtol=RTOL, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, err_msg=what)


def f64(t):
    return np.asarray(t.detach().double() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float64))


def cfgs(arch):
    return (jconfigs.reduced(jconfigs.get_config(arch), layers=2, d_model=128),
            configs.reduced(configs.get_config(arch), layers=2, d_model=128))


_INIT = {}


def jax_params(arch, dtype=jnp.float32):
    """The JAX package's initial parameters of the reduced ``arch`` (cached)."""
    if (arch, dtype) not in _INIT:
        jcfg, _ = cfgs(arch)
        _INIT[(arch, dtype)] = JaxDecoderLM(jcfg, dtype=dtype).init(jax.random.PRNGKey(0))
    return _INIT[(arch, dtype)]


def tokens_labels(vocab, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, lead + (B, S + 1)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :3] = -1                                   # ignored positions
    labels[..., -5:-2] = -1
    return toks[..., :-1], labels


def leaves_of(params):
    return {n: t.detach().clone().requires_grad_() for n, t in params.items()}


# ---------------------------------------------------------------------------
# DecoderLM.loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg = cfgs(arch)
    jp = jax_params(arch)
    toks, labels = tokens_labels(cfg.vocab_size)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jnp.asarray(labels))
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    params = leaves_of(trainer_params_from_jax(jax.device_get(jp), "cpu"))
    loss = model.loss(params, torch.tensor(toks), torch.tensor(labels))
    assert loss.dtype == torch.float32 and loss.shape == ()
    close(loss, jloss, what=arch)
    grads = torch.autograd.grad(loss, list(params.values()))
    want = trainer_params_from_jax(jax.device_get(jgrads), "cpu")
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        assert bool(torch.isfinite(g).all()), name
        close_vec(g, want[name])


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_every_plain_path_trains_as_the_jax_packages(impl):
    arch = "h2o-danube-3-4b"
    jcfg, cfg = cfgs(arch)
    jp = jax_params(arch)
    toks, labels = tokens_labels(cfg.vocab_size, seed=1)
    jm = JaxDecoderLM(jcfg, attn_impl=impl, loss_chunk=LOSS_CHUNK)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jnp.asarray(labels))
    model = DecoderLM(cfg, attn_impl=impl, loss_chunk=LOSS_CHUNK, device="cpu")
    params = leaves_of(trainer_params_from_jax(jax.device_get(jp), "cpu"))
    loss = model.loss(params, torch.tensor(toks), torch.tensor(labels))
    close(loss, jloss)
    want = trainer_params_from_jax(jax.device_get(jgrads), "cpu")
    for (name, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        close_vec(g, want[name])


def test_all_labels_ignored_gives_zero_and_one_chunk_equals_many():
    _, cfg = cfgs("granite-8b")
    params = trainer_params_from_jax(jax.device_get(jax_params("granite-8b")), "cpu")
    toks, labels = (torch.tensor(x) for x in tokens_labels(cfg.vocab_size, seed=2))
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    assert float(model.loss(params, toks, torch.full_like(labels, -1))) == 0.0
    whole = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=512, device="cpu")
    close(model.loss(params, toks, labels), whole.loss(params, toks, labels))


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-2.7b"])
@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_equals_no_remat_in_bits(arch, policy):
    _, cfg = cfgs(arch)
    params = trainer_params_from_jax(jax.device_get(jax_params(arch)), "cpu")
    toks, labels = (torch.tensor(x) for x in tokens_labels(cfg.vocab_size, seed=3))
    out = []
    for remat in (False, True):
        model = DecoderLM(cfg, attn_impl="xla_flash", remat=remat, remat_policy=policy,
                          loss_chunk=LOSS_CHUNK, device="cpu")
        leaves = leaves_of(params)
        loss = model.loss(leaves, toks, labels)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_the_kernel_path_evaluates_but_does_not_train():
    _, cfg = cfgs("h2o-danube-3-4b")
    params = trainer_params_from_jax(jax.device_get(jax_params("h2o-danube-3-4b")), "cpu")
    toks, labels = (torch.tensor(x) for x in tokens_labels(cfg.vocab_size, seed=4))
    kernel = DecoderLM(cfg, attn_impl="kernel", loss_chunk=LOSS_CHUNK, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        kernel.loss(leaves_of(params), toks, labels)
    with torch.no_grad():
        got = kernel.loss(params, toks, labels)
        want = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK,
                         device="cpu").loss(params, toks, labels)
    close(got, want)


def test_loss_refuses_other_parameter_names_and_bad_knobs():
    _, cfg = cfgs("h2o-danube-3-4b")
    model = DecoderLM(cfg, attn_impl="xla_flash", device="cpu")
    params = dict(model.named_parameters())
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="parameter names"):
        model.loss({k: v for k, v in params.items() if k != "head"}, toks, toks)
    with pytest.raises(ValueError, match="remat_policy"):
        DecoderLM(cfg, attn_impl="xla_flash", remat_policy="everything", device="cpu")
    with pytest.raises(ValueError, match="loss_chunk"):
        DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=0, device="cpu")


def test_serving_stays_without_grad():
    _, cfg = cfgs("h2o-danube-3-4b")
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    caches = model.init_cache(1, 8)
    logits, _ = model.prefill(torch.zeros(1, 4, dtype=torch.int64), caches)
    assert not logits.requires_grad


# ---------------------------------------------------------------------------
# the chunked SSD: a finite gradient where the JAX package's is NaN
# ---------------------------------------------------------------------------

def test_the_chunked_ssd_gradient_is_finite_where_the_jax_packages_is_not():
    """Over a 128-step chunk, exp(s_i - s_j) for j > i overflows float32 when
    the decay is strong (here a dt of 0.8 at A = -1 and -2): the JAX package
    selects it away after the exp, and its gradients of dt and A are NaN; the
    port masks before the exp.  Its forward is the JAX package's, and its
    gradients equal the step-by-step recurrence's."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 4, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.8, np.float32)
    a = np.array([-1.0, -2.0], np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jloss(x, dt, a):
        return jnp.sum(jax_ssd_chunked(x, dt, a, bm, cm) * cot)

    jout = jax_ssd_chunked(x, dt, a, bm, cm)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(x, dt, a)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)     # the JAX package's NaN
    args = [torch.tensor(v, requires_grad=True) for v in (x, dt, a)]
    out = ssd_chunked(*args, torch.tensor(bm), torch.tensor(cm))
    close_vec(out.detach(), jout)
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(cot)), args)
    ref_args = [torch.tensor(v, requires_grad=True) for v in (x, dt, a)]
    ref = ssd_scan_ref(*ref_args, torch.tensor(bm), torch.tensor(cm))
    want = torch.autograd.grad(torch.sum(ref * torch.tensor(cot)), ref_args)
    for name, g, w in zip(("x", "dt", "A"), grads, want):
        assert bool(torch.isfinite(g).all()), name
        close_vec(g, w, rtol=1e-4)


# ---------------------------------------------------------------------------
# clip_tree, count_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [0.3, 1e3])
def test_clip_tree_matches_jax(clip):
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
                  "d": rng.standard_normal((2, 2)).astype(np.float32)}}
    jclipped, jnorm = jax_clip_tree(tree, clip)
    clipped, norm = clip_tree(params_from_jax(jax.device_get(tree), "cpu"), clip)
    close(norm, jnorm)
    assert clipped["b"]["c"].dtype == torch.bfloat16 and clipped["a"].dtype == torch.float32
    close_vec(clipped["a"], jclipped["a"])
    close_vec(clipped["b"]["d"], jclipped["b"]["d"])
    np.testing.assert_allclose(f64(clipped["b"]["c"]),
                               np.asarray(jclipped["b"]["c"], np.float64), rtol=2**-7)
    if clip > float(jnorm):      # nothing to clip: every leaf as it was
        assert torch.equal(clipped["a"], torch.tensor(tree["a"]))


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_count_params_matches_jax_at_full_size(name):
    cfg = configs.get_config(name)
    jcfg = jconfigs.get_config(name)
    want = jax_count(JaxEncDecLM(jcfg) if cfg.arch_type == "audio" else JaxDecoderLM(jcfg))
    assert count_params(cfg) == want
    assert is_giant(cfg, want) == jax_is_giant(jconfigs.get_config(name), want)
    assert GIANT_PARAM_THRESHOLD == 20e9


def test_count_params_of_a_model_counts_its_parameters():
    _, cfg = cfgs("gemma-2b")
    model = DecoderLM(cfg, device="cpu")
    assert count_params(model) == count_params(cfg) == jax_count(JaxDecoderLM(cfgs("gemma-2b")[0]))


# ---------------------------------------------------------------------------
# FederatedTrainer.make_train_step
# ---------------------------------------------------------------------------

def jax_round_noise(jtrainer, jp, key, k):
    """The JAX round's noise, as the port's TrainNoise: ``_tree_noise`` of
    the mechanism's key over the (K, ...) clipped tree (LDP) or the mean
    (CDP), and xi of the first extra key."""
    alg = jtrainer.server_algorithm(k)
    k_mech, extra = alg._split_keys(key)
    mech, noise = alg.mechanism, TrainNoise()
    if isinstance(mech, jcomp.GaussianLDP):
        tmpl = jax.tree_util.tree_map(lambda l: jnp.zeros((k,) + l.shape, l.dtype), jp)
        tree = jax.device_get(_tree_noise(k_mech, tmpl, mech.sigma))
        per = [trainer_params_from_jax(jax.tree_util.tree_map(lambda l: l[i], tree), "cpu")
               for i in range(k)]
        noise.tree = {n: torch.stack([p[n] for p in per]) for n in per[0]}
    elif isinstance(mech, jcomp.CentralGaussian):
        std = mech.sigma / math.sqrt(mech.num_clients)
        noise.tree = trainer_params_from_jax(jax.device_get(_tree_noise(k_mech, jp, std)), "cpu")
    if extra and alg.step.uses_extrapolation and mech.needs_xi_key:
        noise.xi = torch.tensor(np.asarray(jax.random.normal(extra[0], ())))
    return noise


def both_steps(name, dtype=jnp.float32, arch="h2o-danube-3-4b", fed=FED):
    """One round of ``name`` in both packages on the same parameters, tokens
    and noise (``fed``: the FederatedConfig fields): (port new params, port
    metrics, JAX new params, JAX metrics, the old params)."""
    jcfg, cfg = cfgs(arch)
    jp = jax_params(arch, dtype)
    jm = JaxDecoderLM(jcfg, dtype=dtype, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK)
    n = jax_count(jm)
    jtrainer = JaxTrainer(jm, jconfigs.FederatedConfig(algorithm=name, **fed), n)
    toks, labels = tokens_labels(cfg.vocab_size, seed=6, lead=(K, TAU))
    key = jax.random.PRNGKey(7)
    jnew, jmet = jax.jit(jtrainer.make_train_step(K))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, key)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    model = DecoderLM(cfg, dtype=tdtype, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK,
                      device="cpu")
    trainer = FederatedTrainer(model, configs.FederatedConfig(algorithm=name, **fed), n)
    params = trainer_params_from_jax(jax.device_get(jp), "cpu")
    new, met = trainer.make_train_step(K)(
        params, {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)},
        torch.Generator().manual_seed(0), noise=jax_round_noise(jtrainer, jp, key, K))
    return new, met, trainer_params_from_jax(jax.device_get(jnew), "cpu"), jmet, params


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    new, met, jnew, jmet, old = both_steps(name)
    for key in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        close(met[key], jmet[key], what=f"{name}: {key}")
    if "fedexp" in name:
        assert float(met["eta_g"]) > 1.05, "the test must exercise the extrapolation"
    assert set(new) == set(jnew) == set(old)
    scale = max(float((jnew[k] - old[k]).abs().max()) for k in new)
    for k in new:
        assert new[k].dtype == old[k].dtype and new[k].shape == old[k].shape
        close_vec(new[k], jnew[k])
        err = float(((new[k] - old[k]) - (jnew[k] - old[k])).abs().max())
        assert err <= RTOL * scale, f"{name}: update of {k} off by {err} (scale {scale})"
    clip = None if name in ("fedavg", "fedexp") else FED["clip_norm"]
    norms = met["client_norms"]
    close(torch.mean(norms), jmet["mean_update_norm"])
    if clip is None:
        assert torch.equal(met["clipped_norms"], norms)
    else:
        assert bool((norms > clip).any()), "the test must exercise the clip"
        close_vec(met["clipped_norms"], torch.clamp(norms, max=clip))


@pytest.mark.parametrize("name", ["fedexp", "ldp-fedexp-gauss", "cdp-fedexp"])
def test_train_step_in_bf16_matches_jax_within_one_ulp(name):
    new, met, jnew, jmet, old = both_steps(name, jnp.bfloat16)
    close(met["loss"], jmet["loss"], 1e-4)
    close(met["eta_g"], jmet["eta_g"], 1e-3)
    for key in ("mean_update_norm", "agg_sq"):
        close(met[key], jmet[key], 1e-2, what=key)
    step = max(float(np.abs(f64(jnew[k]) - f64(old[k])).max()) for k in new)
    num = den = worst = 0.0
    for k in new:
        assert new[k].dtype == torch.bfloat16
        got, want, was = f64(new[k]), f64(jnew[k]), f64(old[k])
        assert np.all(np.abs(got - want) <= 2**-7 * np.abs(want) + step), k
        err = np.sum(np.square((got - was) - (want - was)))
        num, den = num + err, den + np.sum(np.square(want - was))
        worst = max(worst, math.sqrt(err / max(np.sum(np.square(want - was)), 1e-300)))
    print(f"\n{name} bf16: update tree off by {math.sqrt(num / den):.4f} in L2, a leaf by "
          f"up to {worst:.4f}")
    assert math.sqrt(num / den) <= 0.1


def test_the_step_trains_mamba2_as_the_jax_package():
    new, met, jnew, jmet, old = both_steps("cdp-fedexp", arch="mamba2-2.7b")
    for key in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        close(met[key], jmet[key], what=key)
    assert float(met["eta_g"]) > 1.05
    scale = max(float((jnew[k] - old[k]).abs().max()) for k in new)
    worst_tree = worst_leaf = 0.0
    for k in new:
        close_vec(new[k], jnew[k], MAMBA2_RTOL)
        err = float(((new[k] - old[k]) - (jnew[k] - old[k])).abs().max())
        assert err <= MAMBA2_RTOL * scale, f"update of {k} off by {err} (scale {scale})"
        worst_tree = max(worst_tree, err / scale)
        worst_leaf = max(worst_leaf, err / float((jnew[k] - old[k]).abs().max()))
    print(f"\nmamba2: the update off by {worst_leaf:.2e} of a leaf's largest entry, "
          f"{worst_tree:.2e} of the tree's")


@pytest.mark.parametrize("name", ["fedexp", "ldp-fedexp-gauss", "cdp-fedexp"])
def test_the_steps_own_draws_are_draw_noise(name):
    _, cfg = cfgs("granite-8b")
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    fed = configs.FederatedConfig(algorithm=name, **FED)
    trainer = FederatedTrainer(model, fed, count_params(cfg))
    params = trainer_params_from_jax(jax.device_get(jax_params("granite-8b")), "cpu")
    toks, labels = tokens_labels(cfg.vocab_size, seed=8, lead=(K, 1))   # one local step
    batch = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    step = trainer.make_train_step(K)
    a, ma = step(params, batch, torch.Generator().manual_seed(9))
    noise = trainer.draw_noise(params, K, torch.Generator().manual_seed(9))
    b, mb = step(params, batch, torch.Generator().manual_seed(123), noise=noise)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    c, _ = step(params, batch, torch.Generator().manual_seed(10))
    if name == "fedexp":
        assert noise.tree is None and noise.xi is None
        assert all(torch.equal(a[k], c[k]) for k in a)
    else:
        assert not all(torch.equal(a[k], c[k]) for k in a)     # other noise, other round
        lead = (K,) if "ldp" in name else ()
        assert all(noise.tree[k].shape == lead + params[k].shape for k in params)
        assert (noise.xi is not None) == ("cdp" in name)


@pytest.mark.parametrize("name,match", [
    ("dp-fedadam-cdp", "carries server state"),
    ("ldp-gauss-fedadam", "carries server state"),
    ("cdp-fedmom", "carries server state"),
    ("ldp-fedexp-schedule", "no leaf-wise pytree release"),
    ("cdp-fedexp-schedule", "no leaf-wise pytree release"),
    ("ldp-fedexp-privunit", "unsupported datacenter algorithm"),
    ("dp-fedavg-privunit", "unsupported datacenter algorithm"),
    ("cdp-fedexp-adaptive-clip", "unsupported datacenter algorithm"),
    ("ldp-fedexp-perclient", "unsupported datacenter algorithm"),
    ("dp-scaffold", "unsupported datacenter algorithm"),
    ("no-such-algorithm", "unsupported datacenter algorithm"),
])
def test_refusals_match_jax(name, match):
    jcfg, cfg = cfgs("granite-8b")
    model = DecoderLM(cfg, attn_impl="xla_flash", device="cpu")
    trainer = FederatedTrainer(model, configs.FederatedConfig(algorithm=name), 1000)
    jtrainer = JaxTrainer(JaxDecoderLM(jcfg), jconfigs.FederatedConfig(algorithm=name), 1000)
    with pytest.raises(ValueError, match=match) as got:
        trainer.make_train_step(4)
    with pytest.raises(ValueError, match=match) as want:
        jtrainer.make_train_step(4)
    if match != "unsupported datacenter algorithm":    # KeyError texts differ by package
        assert str(got.value) == str(want.value)


def test_the_trainer_refuses_the_kernel_path():
    _, cfg = cfgs("granite-8b")
    with pytest.raises(ValueError, match="no backward"):
        FederatedTrainer(DecoderLM(cfg, attn_impl="kernel", device="cpu"),
                         configs.FederatedConfig(), 1000)


# ---------------------------------------------------------------------------
# conversion and the example
# ---------------------------------------------------------------------------

def test_trainer_params_round_trip_the_jax_layout():
    jp = jax.device_get(jax_params("mamba2-2.7b"))
    back = trainer_params_to_jax(trainer_params_from_jax(jp, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert [p for p, _ in flat] == [p for p, _ in jax.tree_util.tree_leaves_with_path(back)]
    for (_, a), (_, b) in zip(flat, jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    bf = trainer_params_to_jax({"embed": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert bf["embed"].dtype == np.float32 and bf["blocks"] == {}


def test_the_example_trains_on_the_cpu_and_the_jax_package_loads_its_checkpoint(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "train_federated_lm_torch", ROOT / "examples" / "train_federated_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    arch, layers, d_model, vocab, rounds = "granite-8b", 2, 128, 256, 2
    telemetry = tmp_path / "lm.jsonl"
    params = example.main(["--device", "cpu", "--arch", arch, "--layers", str(layers),
                           "--d-model", str(d_model), "--vocab", str(vocab), "--rounds",
                           str(rounds), "--cohort", "2", "--tau", "1", "--batch", "1",
                           "--seq", "24", "--ckpt-dir", str(tmp_path / "ckpt"),
                           "--telemetry", str(telemetry)])
    lines = [json.loads(line) for line in telemetry.read_text().splitlines()]
    assert [line["round"] for line in lines] == list(range(rounds))
    assert all(math.isfinite(line["loss"]) and line["eta"] >= 1.0 for line in lines)

    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch), layers=layers,
                                                d_model=d_model), vocab_size=vocab)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash")
    loaded, meta = jckpt.load_checkpoint(str(tmp_path / "ckpt"), jm.init(jax.random.PRNGKey(0)))
    assert meta["step"] == rounds and meta["algorithm"] == "cdp-fedexp"
    want = trainer_params_to_jax(params)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    toks, labels = tokens_labels(vocab, seed=11)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch), layers=layers,
                                              d_model=d_model), vocab_size=vocab)
    model = DecoderLM(cfg, attn_impl="xla_flash", device="cpu")
    close(model.loss(params, torch.tensor(toks), torch.tensor(labels)),
          jm.loss(loaded, jnp.asarray(toks), jnp.asarray(labels)))
