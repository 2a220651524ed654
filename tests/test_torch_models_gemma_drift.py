"""The bounds of chip_smoke.py's serve-gemma check (phase 8), from the CPU:
an 18-layer bf16 gemma-2b at d_model 512 with its head_dim of 256, the dense
path against the tensor-core kernel's order at Dh 256, and planted mask
faults that must fail the bounds.  Run with -s to see the readings.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_tc_ref  # noqa: E402
from repro_torch.models import DecoderLM, attention  # noqa: E402
from test_torch_drift_helpers import drift, load_chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def bf16_gemma():
    """chip_smoke.py, and an 18-layer bf16 gemma-2b at d_model 512 with its
    head_dim of 256 (2 query heads, MQA, GeGLU, tied embeddings) and its
    prefill logits through the dense path."""
    chip_smoke = load_chip_smoke()
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
    max_rel, mean_rel = drift(model, tokens, plain, capsys, "bf16 drift, Dh-256 tc order")
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
    max_rel, mean_rel = drift(model, tokens, plain, capsys, fault)
    assert max_rel > chip_smoke.SERVE_MAX_ERR and mean_rel > chip_smoke.SERVE_MEAN_ERR
