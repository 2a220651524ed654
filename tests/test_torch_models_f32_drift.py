"""The bounds of chip_smoke.py's serve-f32 check (phase 9), from the CPU: a
24-layer float32 h2o-danube-3-4b at d_model 512, the dense path against the
float32 tensor-core kernel's 3xTF32 order, and a dropped window that must
fail the bounds.  Run with -s to see the readings.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_tc_ref  # noqa: E402
from repro_torch.models import DecoderLM, attention  # noqa: E402
from test_torch_drift_helpers import drift, load_chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def f32_serve():
    """chip_smoke.py, and the bf16 fixture's h2o-danube-3-4b at d_model 512
    and its depth of 24 layers, in float32 (the models' default dtype), with
    its prefill logits through the dense path."""
    chip_smoke = load_chip_smoke()
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
    max_rel, mean_rel = drift(model, tokens, plain, capsys, "f32 drift, 3xTF32 order")
    assert 0 < max_rel < chip_smoke.SERVE_F32_MAX_ERR
    assert mean_rel < chip_smoke.SERVE_F32_MEAN_ERR


def test_a_dropped_window_fails_the_f32_serve_bounds(f32_serve, monkeypatch, capsys):
    """The plain path with the window dropped against the right one, in
    float32: chip_smoke.py plants it at full width in phase 9 and fails if
    the bounds do not see it."""
    chip_smoke, model, tokens, plain = f32_serve
    monkeypatch.setattr(model, "attn_impl", "dense")
    monkeypatch.setattr(model, "cfg", dataclasses.replace(model.cfg, sliding_window=None))
    max_rel, mean_rel = drift(model, tokens, plain, capsys, "f32, window dropped")
    assert max_rel > chip_smoke.SERVE_F32_MAX_ERR and mean_rel > chip_smoke.SERVE_F32_MEAN_ERR
