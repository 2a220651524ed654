"""The port's hybrid (zamba2) and VLM (chameleon) decoder LMs against the JAX
package's, on the CPU.

The hybrid at ``layers=4, hybrid_attn_every=2``: two super-blocks of two
Mamba2 layers, each followed by the one weight-shared attention(+MLP) block,
so its gradient is the sum over two sites; ``reduced(chameleon-34b)`` (qk-norm,
an untied head).  For each: the loss and every leaf's gradient, greedy
tokens of a prefill and 4 decode steps (JAX's flash kernel in interpret mode,
the port's kernel path's plain versions); for the hybrid also remat = no
remat in bits, the refusal of a depth that is no whole number of
super-blocks, the converters' ``shared_attn`` and one ``FederatedTrainer``
round against the JAX package's jitted ``train_step`` on its own noise.

Tolerances (``tests/test_torch_train.py``'s).  Float32 at rtol 1e-5 with an
atol of 1e-5 times the largest entry; the hybrid's gradients at
``MAMBA2_RTOL`` (1e-4), as mamba2-2.7b's round: every leaf's gradient passes
back through four Mamba2 blocks, the chunked SSD's chained exp and cumsum,
and lands up to 5.1e-5 of its largest entry off (``-s`` prints the
readings) while the loss agrees at 1e-5.  The
round (two local steps, then FedEXP's extrapolation at eta_g 1.95) is
ill-conditioned as a Mamba2 round is: when the weights move by float32's
unit roundoff (2^-24 relative) the port's own update moves by up to 1.6e-4
of a leaf's largest entry, and the gap to JAX's is of that order.  So its
update tree is held by ``tests/test_torch_cuda.py``'s rule for such rounds:
within 1e-4 of the tree's largest entry, or four times the round's own
spread over two such perturbations where that is larger, the bound under
1e-2 of the tree (a planted eta_g = 1 would move it by 1 - 1/eta_g); its
loss and metrics at 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.rules import count_params as jax_count  # noqa: E402
from repro.launch.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.launch.train import FederatedTrainer as JaxTrainer  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    decoder_from_jax,
    trainer_params_from_jax,
    trainer_params_to_jax,
)
from repro_torch.launch import FederatedTrainer, ServeEngine, count_params  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from test_torch_train import (  # noqa: E402
    FED,
    LOSS_CHUNK,
    MAMBA2_RTOL,
    RTOL,
    close,
    close_vec,
    jax_round_noise,
    leaves_of,
    tokens_labels,
)

ZAMBA2, CHAMELEON = "zamba2-2.7b", "chameleon-34b"
LAYERS = {ZAMBA2: 4, CHAMELEON: 2}
PROMPT, NEW = 40, 5          # a prefill, then 4 decode steps
K, TAU = 2, 2

_INIT = {}


def lm_pair(name, d_model=128):
    kw = dict(layers=LAYERS[name], d_model=d_model)
    return (jconfigs.reduced(jconfigs.get_config(name), **kw),
            configs.reduced(configs.get_config(name), **kw))


def jax_params(name):
    if name not in _INIT:
        _INIT[name] = JaxDecoderLM(lm_pair(name)[0]).init(jax.random.PRNGKey(0))
    return _INIT[name]


def rtol_of(name: str) -> float:
    """The hybrid's leaves at MAMBA2_RTOL (every gradient passes through a
    Mamba2 block's backward), the VLM's at RTOL."""
    return MAMBA2_RTOL if name == ZAMBA2 else RTOL


def test_the_hybrid_config_has_two_sites_of_the_shared_block():
    _, cfg = lm_pair(ZAMBA2)
    assert (cfg.arch_type, cfg.num_layers, cfg.hybrid_attn_every) == ("hybrid", 4, 2)
    model = DecoderLM(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(n for n in names if n.startswith("shared_attn.")) == sorted(
        "shared_attn." + n for n in jax_params(ZAMBA2)["shared_attn"])
    caches = model.init_cache(2, 16)
    assert (len(caches["ssm"]), len(caches["attn"])) == (4, 2)
    assert count_params(model) == count_params(cfg) == jax_count(JaxDecoderLM(lm_pair(ZAMBA2)[0]))


@pytest.mark.parametrize("name", [ZAMBA2, CHAMELEON])
def test_loss_and_gradients_match_jax(name):
    jcfg, cfg = lm_pair(name)
    jp = jax_params(name)
    toks, labels = tokens_labels(cfg.vocab_size)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jnp.asarray(labels))
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    params = leaves_of(trainer_params_from_jax(jax.device_get(jp), "cpu"))
    assert set(params) == {n for n, _ in model.named_parameters()}
    loss = model.loss(params, torch.tensor(toks), torch.tensor(labels))
    close(loss, jloss, what=name)
    want = trainer_params_from_jax(jax.device_get(jgrads), "cpu")
    worst = 0.0
    for (leaf, _), g in zip(params.items(), torch.autograd.grad(loss, list(params.values()))):
        assert bool(torch.isfinite(g).all()), leaf
        close_vec(g, want[leaf], rtol_of(name))
        w = want[leaf].double()
        worst = max(worst, float((g.double() - w).abs().max() / w.abs().max()))
    print(f"\n{name}: a leaf's gradient off by up to {worst:.2e} of its largest entry "
          f"(rtol {rtol_of(name):g})")


def test_remat_equals_no_remat_in_bits():
    _, cfg = lm_pair(ZAMBA2)
    params = trainer_params_from_jax(jax.device_get(jax_params(ZAMBA2)), "cpu")
    toks, labels = (torch.tensor(t) for t in tokens_labels(cfg.vocab_size, seed=3))
    out = []
    for remat in (False, True):
        model = DecoderLM(cfg, attn_impl="xla_flash", remat=remat, loss_chunk=LOSS_CHUNK,
                          device="cpu")
        leaves = leaves_of(params)
        loss = model.loss(leaves, toks, labels)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_a_depth_of_no_whole_super_block_raises_in_both():
    jcfg, cfg = lm_pair(ZAMBA2)
    jcfg, cfg = (dataclasses.replace(c, num_layers=3) for c in (jcfg, cfg))
    toks = np.zeros((1, 8), np.int32)
    jm = JaxDecoderLM(jcfg)
    with pytest.raises(TypeError, match="reshape"):
        jm.forward(jm.init(jax.random.PRNGKey(0)), jnp.asarray(toks))
    with pytest.raises(ValueError, match="super-blocks"):
        DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))(
            torch.tensor(toks))


def test_the_converters_carry_the_shared_block():
    jp = jax.device_get(jax_params(ZAMBA2))
    back = trainer_params_to_jax(trainer_params_from_jax(jp, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert [p for p, _ in flat] == [p for p, _ in jax.tree_util.tree_leaves_with_path(back)]
    for (_, a), (_, b) in zip(flat, jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    _, cfg = lm_pair(ZAMBA2)
    model = decoder_from_jax(cfg, jp, "cpu")
    for n, t in jp["shared_attn"].items():
        np.testing.assert_array_equal(model.shared_attn[n].numpy(), np.asarray(t))
    missing = {k: v for k, v in jp.items() if k != "shared_attn"}
    with pytest.raises(ValueError, match="parameter names"):
        decoder_from_jax(cfg, missing, "cpu")
    extra = {**jp, "shared_attn": {**jp["shared_attn"], "attn_extra": jp["final_norm"]}}
    with pytest.raises(ValueError, match="shared block parameters"):
        decoder_from_jax(cfg, extra, "cpu")
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="parameter names"), torch.no_grad():
        model.loss({k: v for k, v in trainer_params_from_jax(jp, "cpu").items()
                    if k != "shared_attn.ln1"}, toks, toks)


@pytest.mark.parametrize("name", [ZAMBA2, CHAMELEON])
def test_greedy_tokens_equal_jax(name):
    jcfg = jconfigs.reduced(jconfigs.get_config(name), layers=LAYERS[name])
    cfg = configs.reduced(configs.get_config(name), layers=LAYERS[name])
    jm = JaxDecoderLM(jcfg, attn_impl="pallas")
    params = jm.init(jax.random.PRNGKey(1))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    want = JaxServeEngine(jm).generate(params, jnp.asarray(prompt), NEW, PROMPT + NEW,
                                       dtype=jnp.float32)
    model = decoder_from_jax(cfg, jax.device_get(params), "cpu")
    got = ServeEngine(model).generate(torch.tensor(prompt), NEW, PROMPT + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_federated_round_of_the_hybrid_matches_jax():
    """cdp-fedexp, K = 2 clients of tau = 2 steps, JAX's own noise: the
    shared block's leaves move by the update of their two sites' summed
    gradient in both packages."""
    name = "cdp-fedexp"
    jcfg, cfg = lm_pair(ZAMBA2)
    jp = jax_params(ZAMBA2)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK)
    n = jax_count(jm)
    jtrainer = JaxTrainer(jm, jconfigs.FederatedConfig(algorithm=name, **FED), n)
    toks, labels = tokens_labels(cfg.vocab_size, seed=6, lead=(K, TAU))
    key = jax.random.PRNGKey(7)
    jnew, jmet = jax.jit(jtrainer.make_train_step(K))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, key)
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    trainer = FederatedTrainer(model, configs.FederatedConfig(algorithm=name, **FED), n)
    old = trainer_params_from_jax(jax.device_get(jp), "cpu")
    batch = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    noise = jax_round_noise(jtrainer, jp, key, K)
    step = trainer.make_train_step(K)
    new, met = step(old, batch, torch.Generator().manual_seed(0), noise=noise)
    jnew = trainer_params_from_jax(jax.device_get(jnew), "cpu")
    for k in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        close(met[k], jmet[k], what=k)
    assert float(met["eta_g"]) > 1.05
    spread = 0.0
    for seed in (11, 12):
        g = torch.Generator().manual_seed(seed)
        moved = {k: p * (1 + 2.0**-24 * torch.randn(p.shape, generator=g)) for k, p in old.items()}
        again, _ = step(moved, batch, torch.Generator().manual_seed(0), noise=noise)
        spread = max([spread] + [float(((again[k] - moved[k]) - (new[k] - old[k])).abs().max())
                                 for k in new])
    scale = max(float((jnew[k] - old[k]).abs().max()) for k in new)
    bound = max(MAMBA2_RTOL * scale, 4 * spread)
    assert bound <= 1e-2 * scale, (spread, scale)
    worst = 0.0
    for k in new:
        err = float(((new[k] - old[k]) - (jnew[k] - old[k])).abs().max())
        assert err <= bound, f"update of {k} off by {err} (scale {scale}, spread {spread})"
        worst = max(worst, err / scale)
    assert not torch.equal(new["shared_attn.attn_wq"], old["shared_attn.attn_wq"])
    print(f"\nhybrid round: the update off by {worst:.2e} of the tree's largest entry, the "
          f"port's own spread {spread / scale:.2e}")


def test_the_example_trains_the_hybrid_and_the_jax_package_loads_its_checkpoint(tmp_path):
    """``examples/train_federated_lm_torch.py --arch zamba2-2.7b`` on the CPU:
    its checkpoint, ``shared_attn`` nested as the JAX package nests it, loads
    into the JAX package's hybrid, whose loss on it is the port's."""
    import importlib.util
    from pathlib import Path

    from repro import checkpoint as jckpt
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "train_federated_lm_torch", root / "examples" / "train_federated_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    kw = dict(layers=2, d_model=64)
    params = example.main(["--device", "cpu", "--arch", ZAMBA2, "--layers", "2", "--d-model",
                           "64", "--vocab", "128", "--rounds", "2", "--cohort", "2", "--tau",
                           "1", "--batch", "1", "--seq", "16", "--ckpt-dir",
                           str(tmp_path / "ckpt")])
    assert any(k.startswith("shared_attn.") for k in params)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(ZAMBA2), **kw),
                               vocab_size=128)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash")
    loaded, meta = jckpt.load_checkpoint(str(tmp_path / "ckpt"), jm.init(jax.random.PRNGKey(0)))
    assert meta["step"] == 2
    want = trainer_params_to_jax(params)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    toks, labels = tokens_labels(128, seed=11)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(ZAMBA2), **kw), vocab_size=128)
    model = DecoderLM(cfg, attn_impl="xla_flash", device="cpu")
    close(model.loss(params, torch.tensor(toks), torch.tensor(labels)),
          jm.loss(loaded, jnp.asarray(toks), jnp.asarray(labels)))
