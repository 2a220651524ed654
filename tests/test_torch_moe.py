"""The port's MoE block and MoE decoder LM against the JAX package's, on the
CPU.

``moe_apply`` at ``reduced(granite-moe-1b-a400m)`` (4 experts, top-2, float32
combine), at a capacity factor of 0.5 (tokens dropped), and at
``reduced(llama4-maverick-400b-a17b)`` (top-1, shared expert, the combine in
the model dtype) in bf16; a router whose experts tie in pairs, where the
slot order must be ``lax.top_k``'s (lower index first); the MoE
``DecoderLM``: loss with the aux term and every leaf's gradient, greedy
tokens of a prefill and 4 decode steps, and one ``FederatedTrainer`` round
against the JAX package's jitted ``train_step`` on its own noise.  Weights
are JAX-initialised and carried across with ``repro_torch.convert``; inputs
are numpy-seeded.

Tolerances.  Float32: rtol 1e-5 with an atol of 1e-5 times the largest
entry (``tests/test_torch_train.py``: the same products summed in other
orders); the decoder's loss and gradients and the round as that file holds
them.  bf16 (the llama4 variant): both packages round every product and
activation to bf16, but XLA fuses the SwiGLU chain in float32 where PyTorch
rounds after each op, so the outputs differ by bf16 ulps: each output within
2^-6 of the largest (four ulps of it), the aux loss at 1e-5, and the routing
(expert ids and drops) equal.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    decoder_from_jax,
    params_from_jax,
    trainer_params_from_jax,
)
from repro_torch.launch import ServeEngine, count_params  # noqa: E402
from repro_torch.models import DecoderLM, moe  # noqa: E402
from test_torch_train import (  # noqa: E402
    FED,
    LOSS_CHUNK,
    RTOL,
    both_steps,
    cfgs,
    close,
    close_vec,
    leaves_of,
    tokens_labels,
)

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
BF16_REL = 2**-6
PROMPT, NEW = 40, 5          # a prefill, then 4 decode steps
ROUND_FED = dict(FED, clip_norm=0.2)   # the MoE updates' norms are near 0.25: the clip binds


def cfg_pair(name, **changes):
    return (dataclasses.replace(jconfigs.reduced(jconfigs.get_config(name)), **changes),
            dataclasses.replace(configs.reduced(configs.get_config(name)), **changes))


def block_inputs(jcfg, dtype=jnp.float32, seed=0, b=2, s=45):
    """JAX-initialised MoE weights (``moe_defs``) and a numpy-seeded x."""
    jp = jax_init_params(jax.random.PRNGKey(seed), jax_moe.moe_defs(jcfg), dtype)
    x = np.random.default_rng(seed).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    return jp, jnp.asarray(x, dtype)


def to_port(jp, x):
    return params_from_jax(jax.device_get(jp), "cpu"), params_from_jax(jax.device_get(x), "cpu")


def jax_route(jp, x, jcfg):
    """The JAX block's routing: (probs, expert ids in lax.top_k's order)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xf @ jp["moe_router"]).astype(jnp.float32), axis=-1)
    return probs, jax.lax.top_k(probs, jcfg.top_k)[1]


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
def test_moe_apply_matches_jax_with_its_gradients(cf):
    jcfg, cfg = cfg_pair(GRANITE, capacity_factor=cf)
    jp, jx = block_inputs(jcfg)
    cot = np.random.default_rng(1).standard_normal(jx.shape).astype(np.float32)

    def jloss(params, x):
        y, aux = jax_moe.moe_apply(params, x, jcfg)
        return jnp.sum(y * cot) + aux

    jy, jaux = jax_moe.moe_apply(jp, jx, jcfg)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    p, x = to_port(jp, jx)
    p = leaves_of(p)
    x = x.requires_grad_()
    y, aux = moe.moe_apply(p, x, cfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.shape == ()
    close_vec(y.detach(), jy)
    close(aux, jaux)
    share = moe.dropped_share(p, x.detach(), cfg)
    # at cf 0.5 a quarter of the slots' capacity fits at most half the tokens
    assert (share > 0.2) if cf < 1 else (share < 0.2), share
    grads = torch.autograd.grad(torch.sum(y * torch.tensor(cot)) + aux, [x, *p.values()])
    close_vec(grads[0], jgx)
    for name, g in zip(p, grads[1:]):
        close_vec(g, jgp[name])


def test_the_capacity_truncates_before_the_ceiling():
    _, cfg = cfg_pair(GRANITE)
    # cf * T = 1.25 * 90 = 112.5 -> 112 -> ceil(112 / 4) = 28; and the floor of 4
    assert moe.capacity(cfg, 90) == 28 == -(-112 // 4)
    assert moe.capacity(cfg, 2) == 4
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=1.0), 401) == 101


def test_tied_probabilities_keep_lax_top_ks_order():
    """Experts 2 and 3 copy the router columns of experts 0 and 1, so every
    token's probabilities tie in pairs: the top-2 are a tied pair, and which
    comes first decides the slots, the capacity positions and the drops."""
    jcfg, cfg = cfg_pair(GRANITE, capacity_factor=0.5)
    jp, jx = block_inputs(jcfg, seed=3)
    router = np.asarray(jp["moe_router"])
    router = np.concatenate([router[:, :2], router[:, :2]], axis=1)
    jp = {**jp, "moe_router": jnp.asarray(router)}
    probs, jidx = jax_route(jp, jx, jcfg)
    p, x = to_port(jp, jx)
    tprobs, _, idx, _ = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    assert torch.equal(tprobs[:, :2], tprobs[:, 2:])            # every token ties
    assert np.array_equal(np.asarray(probs[:, :2]), np.asarray(probs[:, 2:]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert bool((idx[:, 0] < idx[:, 1]).all())                  # the lower index first
    jy, jaux = jax_moe.moe_apply(jp, jx, jcfg)
    y, aux = moe.moe_apply(p, x, cfg)
    close_vec(y, jy)
    close(aux, jaux)
    assert moe.dropped_share(p, x, cfg) > 0.2


def test_llama4s_top1_shared_expert_in_bf16():
    jcfg, cfg = cfg_pair(LLAMA4)
    assert (cfg.top_k, cfg.moe_shared_expert) == (1, True)
    jp, jx = block_inputs(jcfg, jnp.bfloat16, seed=4)
    jy, jaux = jax_moe.moe_apply(jp, jx, jcfg)
    p, x = to_port(jp, jx)
    y, aux = moe.moe_apply(p, x, cfg)
    assert y.dtype == torch.bfloat16 and set(p) >= {"moe_shared_wi", "moe_shared_wo"}
    _, jidx = jax_route(jp, jx, jcfg)
    _, _, idx, _ = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want = np.asarray(jy, np.float32)
    err = np.abs(y.float().numpy() - want).max() / np.abs(want).max()
    print(f"\nllama4 top-1 bf16: max |d y| {err:.4f} of max |y|")
    assert err <= BF16_REL
    close(aux, jaux)


# ---------------------------------------------------------------------------
# the MoE DecoderLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_loss_with_aux_and_gradients_match_jax(name):
    jcfg, cfg = cfgs(name)
    jm = JaxDecoderLM(jcfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK)
    jp = jm.init(jax.random.PRNGKey(0))
    toks, labels = tokens_labels(cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jnp.asarray(labels))
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu")
    params = leaves_of(trainer_params_from_jax(jax.device_get(jp), "cpu"))
    assert set(params) == {n for n, _ in model.named_parameters()}
    assert params["blocks.1.moe_wi"].shape == (cfg.num_experts, cfg.d_model, 2 * cfg.d_ff)
    loss = model.loss(params, torch.tensor(toks), torch.tensor(labels))
    close(loss, jloss)
    # the aux term weighs 100x the tolerance: a loss without it fails the check
    _, jaux = jm.forward(jp, jnp.asarray(toks))
    assert 0.01 * float(jaux) > 100 * RTOL * float(jloss)
    want = trainer_params_from_jax(jax.device_get(jgrads), "cpu")
    grads = torch.autograd.grad(loss, list(params.values()))
    for (n, _), g in zip(params.items(), grads):
        assert bool(torch.isfinite(g).all()), n
        close_vec(g, want[n])
    assert float(grads[list(params).index("blocks.0.moe_router")].abs().max()) > 0


def test_remat_equals_no_remat_in_bits():
    _, cfg = cfgs(GRANITE)
    model = DecoderLM(cfg, attn_impl="xla_flash", loss_chunk=LOSS_CHUNK, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    toks, labels = (torch.tensor(t) for t in tokens_labels(cfg.vocab_size, seed=3))
    out = []
    for remat in (False, True):
        model.remat = remat
        leaves = leaves_of(params)
        loss = model.loss(leaves, toks, labels)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("name", [GRANITE, LLAMA4])
def test_greedy_tokens_equal_jax(name):
    jcfg, cfg = jconfigs.reduced(jconfigs.get_config(name)), configs.reduced(
        configs.get_config(name))
    jm = JaxDecoderLM(jcfg, attn_impl="pallas")
    params = jm.init(jax.random.PRNGKey(1))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    want = JaxServeEngine(jm).generate(params, jnp.asarray(prompt), NEW, PROMPT + NEW,
                                       dtype=jnp.float32)
    model = decoder_from_jax(cfg, jax.device_get(params), "cpu")
    assert count_params(model) == count_params(cfg) == jax_count(jm)
    got = ServeEngine(model).generate(torch.tensor(prompt), NEW, PROMPT + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_federated_round_matches_jax():
    """ldp-fedexp-gauss, K = 2 clients of tau = 2 steps: every leaf's update,
    the expert tensors' included, with JAX's own per-client noise."""
    new, met, jnew, jmet, old = both_steps("ldp-fedexp-gauss", arch=GRANITE, fed=ROUND_FED)
    for k in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        close(met[k], jmet[k], what=k)
    assert float(met["eta_g"]) > 1.05
    assert bool((met["client_norms"] > ROUND_FED["clip_norm"]).any())
    scale = max(float((jnew[k] - old[k]).abs().max()) for k in new)
    for k in new:
        close_vec(new[k], jnew[k])
        err = float(((new[k] - old[k]) - (jnew[k] - old[k])).abs().max())
        assert err <= RTOL * scale, f"update of {k} off by {err} (scale {scale})"
    assert not torch.equal(new["blocks.0.moe_wi"], old["blocks.0.moe_wi"])
