"""The bounds of chip_smoke.py's full-width bf16 serve check (phase 6), from
the CPU: a 24-layer bf16 h2o-danube-3-4b at d_model 512 (window 64), the
dense path against each flash kernel's order of sums, and planted mask
faults that must fail the bounds.  Run with -s to see the readings.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_tc_ref  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from test_torch_drift_helpers import load_chip_smoke, serve_drift, simt_order  # noqa: E402


@pytest.fixture(scope="module")
def bf16_serve():
    """chip_smoke.py, and a 24-layer bf16 h2o-danube-3-4b at d_model 512
    (window 64) with its prefill logits through the dense path."""
    chip_smoke = load_chip_smoke()
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


@pytest.mark.parametrize("order", ["simt", "tensor-core"])
def test_bf16_drift_between_attention_orders_is_within_the_serve_bounds(bf16_serve, monkeypatch,
                                                                        capsys, order):
    """The bound of chip_smoke.py's full-width serve check, from the CPU: at
    full depth in bf16, the dense path against each kernel's order (the SIMT
    kernel's float32 tiles; the tensor-core kernel's 128-key tiles with p
    rounded to bf16) moves the prefill logits only by bf16 rounding carried
    through 24 layers."""
    chip_smoke = bf16_serve[0]
    attend = simt_order if order == "simt" else attention_tc_ref
    max_rel, mean_rel = serve_drift(bf16_serve, monkeypatch, attend, capsys,
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
        return simt_order(q, k, v, causal=causal, window=window)

    chip_smoke = bf16_serve[0]
    max_rel, mean_rel = serve_drift(bf16_serve, monkeypatch, attend, capsys, fault)
    assert max_rel > chip_smoke.SERVE_MAX_ERR and mean_rel > chip_smoke.SERVE_MEAN_ERR
