"""The port's ServeEngine against the JAX package's, and the converter of
JAX parameters, on the CPU.

Greedy generation must give the JAX package's tokens exactly, for
``reduced(h2o-danube-3-4b)`` (window 64), ``reduced(gemma-2b)`` and the same
at gemma-2b's head_dim of 256 (the tensor-core flash kernel's 64-key route on
the card), with a prompt longer than the window, so that the prefill fills the ring past its
end and the decode steps evict the oldest slots, and for
``reduced(mamba2-2.7b)`` (prefill into the conv window and SSM state, then
the O(1) decode step).  JAX runs its Pallas flash kernel in interpret mode
and its chunked SSD; the port's kernel path runs the kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.launch.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.models.transformer import DecoderLM as JaxDecoderLM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import decoder_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import ServeEngine  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM  # noqa: E402

PROMPT, NEW = 90, 8
HEAD_DIM = {"gemma-2b-dh256": ("gemma-2b", 256)}   # a reduced config at another head_dim


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "gemma-2b", "mamba2-2.7b", "gemma-2b-dh256"])
def test_greedy_tokens_equal_jax(name):
    name, head_dim = HEAD_DIM.get(name, (name, None))
    jcfg, cfg = jax_reduced(jax_get_config(name)), reduced(get_config(name))
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    jm = JaxDecoderLM(jcfg, attn_impl="pallas")
    params = jm.init(jax.random.PRNGKey(1))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    want = JaxServeEngine(jm).generate(params, jnp.asarray(prompt), NEW, PROMPT + NEW,
                                       dtype=jnp.float32)
    model = decoder_from_jax(cfg, jax.device_get(params), "cpu")
    got = ServeEngine(model).generate(torch.tensor(prompt), NEW, PROMPT + NEW)
    assert got.shape == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_params_from_jax_takes_bf16_leaves():
    rng = np.random.default_rng(0)
    tree = jax.device_get({"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                           "b": jnp.asarray(rng.standard_normal(4), jnp.float32)})
    assert tree["w"].dtype.name == "bfloat16"
    out = params_from_jax(tree, "cpu")
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    # the same 16 bits, not a value rounded through another type
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy(),
                                  np.asarray(tree["w"]).view(np.int16))
    np.testing.assert_array_equal(out["w"].float().numpy(), np.asarray(tree["w"], np.float32))


def test_decoder_from_jax_unstacks_the_blocks():
    jcfg = jax_reduced(jax_get_config("h2o-danube-3-4b"), layers=3)
    params = jax.device_get(JaxDecoderLM(jcfg, dtype=jnp.bfloat16).init(jax.random.PRNGKey(2)))
    model = decoder_from_jax(reduced(get_config("h2o-danube-3-4b"), layers=3), params, "cpu")
    assert model.dtype == torch.bfloat16 and len(model.blocks) == 3
    for name, stacked in params["blocks"].items():
        for i, block in enumerate(model.blocks):
            np.testing.assert_array_equal(block[name].float().numpy(),
                                          np.asarray(stacked[i], np.float32), err_msg=name)
    np.testing.assert_array_equal(model.head.float().numpy(), np.asarray(params["head"], np.float32))
    with pytest.raises(ValueError, match="layers stacked"):
        decoder_from_jax(reduced(get_config("h2o-danube-3-4b"), layers=2), params, "cpu")


def test_unported_stacks_and_a_missing_card_raise():
    for name in ("granite-moe-1b-a400m", "zamba2-2.7b", "chameleon-34b"):   # ported now
        model = DecoderLM(reduced(get_config(name)), device="cpu")
        assert model.cfg.arch_type in ("moe", "hybrid", "vlm")
        assert (model.shared_attn is not None) == (name == "zamba2-2.7b")
    whisper = reduced(get_config("whisper-large-v3"))      # ported now, as EncDecLM
    encdec = EncDecLM(whisper, device="cpu")
    assert len(encdec.enc_blocks) == len(encdec.dec_blocks) == 2
    with pytest.raises(NotImplementedError, match="EncDecLM"):
        DecoderLM(whisper, device="cpu")
    cfg = reduced(get_config("h2o-danube-3-4b"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        DecoderLM(cfg, device="cpu", attn_impl="pallas")   # the JAX package's name of "kernel"
    for impl in ("xla_flash", "chunked"):                  # the training paths build
        assert DecoderLM(cfg, device="cpu", attn_impl=impl).attn_impl == impl
    if torch.cuda.is_available():
        pytest.skip("the missing-card error needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderLM(cfg)    # the default device is the card
