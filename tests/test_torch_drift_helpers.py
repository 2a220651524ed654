"""Shared by the CPU drift tests of the serve paths
(``test_torch_models_*_drift.py``, ``test_torch_ssm_drift.py``); it holds
no test.  The loader of ``chip_smoke.py``, whose bounds they hold, the
SIMT kernel's order of sums, and the two ratios of prefill logits that
chip_smoke.py reads on the card."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ref import attention_tc_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402


def load_chip_smoke():
    """``chip_smoke.py`` as a module (importing it runs no phase)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def simt_order(q, k, v, *, causal=True, window=None):
    """The SIMT kernel's order of float32 sums on the CPU: 64-key tiles,
    online softmax, p in float32."""
    return attention_tc_ref(q.float(), k.float(), v.float(), causal=causal, window=window,
                            block_k=64).to(q.dtype)


def drift(model, tokens, plain, capsys, label):
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


def serve_drift(bf16_serve, monkeypatch, attend, capsys, label):
    """The two ratios for the logits of ``attend`` in place of the kernel."""
    _, model, tokens, plain = bf16_serve
    monkeypatch.setattr(attention, "flash_attention", attend)
    return drift(model, tokens, plain, capsys, label)
