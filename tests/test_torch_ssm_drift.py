"""The bounds of chip_smoke.py's full-width Mamba2 serve check (phase 7),
from the CPU: a 64-layer bf16 mamba2-2.7b at d_model 512 with Mamba2's A
and dt ranges, the kernels' stage order against the dense path, and planted
SSD faults that must fail the bounds.  Run with -s to see the readings.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_stages_ref  # noqa: E402
from repro_torch.models import DecoderLM, ssm  # noqa: E402
from test_torch_drift_helpers import load_chip_smoke  # noqa: E402

chip_smoke = load_chip_smoke()


def _diagonal_dropped(x, dt, a, bmat, cmat):
    """A planted fault: ``ssd_chunked`` without each step's own input
    (j = i, where the decay is 1), so it sums over j < i only."""
    own = torch.einsum("bln,bln->bl", cmat.float(), bmat.float())[..., None, None] \
        * (dt.float()[..., None] * x.float())
    return ssm.ssd_chunked(x, dt, a, bmat, cmat) - own


@pytest.fixture(scope="module")
def bf16_mamba2():
    """A 64-layer bf16 mamba2-2.7b at d_model 512 (its
    state, head and conv widths kept; vocab 4000) with Mamba2's A and dt
    ranges, and its hidden states through the plain (dense) path."""
    cfg = dataclasses.replace(configs.get_config("mamba2-2.7b"), d_model=512, vocab_size=4000)
    model = DecoderLM(cfg, dtype=torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    chip_smoke.mamba2_ranges_(model, torch.Generator().manual_seed(2))
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=torch.Generator().manual_seed(1))
    model.attn_impl = "dense"
    plain = model(tokens)
    model.attn_impl = "kernel"
    return model, tokens, plain


def _ssm_drift(bf16_mamba2, monkeypatch, scan, capsys, label):
    """chip_smoke.py's readings for the kernel path with ``scan`` in place of
    the kernel, against the dense path: the last position's logits and the
    hidden states at every position.  Printed (run with -s to see them)."""
    model, tokens, plain = bf16_mamba2
    monkeypatch.setattr(ssm, "ssd_scan", scan)
    hidden = model(tokens)
    r = chip_smoke.ssm_drift(model.logits(hidden[:, -1]), model.logits(plain[:, -1]), hidden, plain)
    with capsys.disabled():
        print(f"\n{label} over 64 layers: logits max {r['logits_max']:.4f} of max|logit|, "
              f"mean {r['logits_mean']:.4f} of the std; hidden states at every position mean "
              f"{r['hidden_mean']:.4f} of the std")
    return r


def test_bf16_drift_between_ssd_orders_is_within_the_serve_bounds(bf16_mamba2, monkeypatch,
                                                                  capsys):
    """At full depth in bf16, two float32 SSD orders (ssd_chunked at 128-step
    chunks, and the CUDA kernels' stage order at their chunk) move the outputs
    only by bf16 rounding carried through 64 layers."""
    r = _ssm_drift(bf16_mamba2, monkeypatch,
                   lambda *args: ssd_scan_stages_ref(*args, chunk=ops.CHUNK), capsys,
                   "bf16 drift")
    assert 0 < r["logits_max"] and chip_smoke.ssm_within_bounds(r)


@pytest.mark.parametrize("fault", ["carry reset at every chunk", "diagonal dropped"])
def test_a_planted_ssd_fault_fails_the_serve_bounds(bf16_mamba2, monkeypatch, capsys, fault):
    scan = {"carry reset at every chunk": chip_smoke.carry_reset(ssm.ssd_chunked),
            "diagonal dropped": _diagonal_dropped}[fault]
    r = _ssm_drift(bf16_mamba2, monkeypatch, scan, capsys, fault)
    assert r["logits_max"] > chip_smoke.SSM_MAX_ERR and r["logits_mean"] > chip_smoke.SSM_MEAN_ERR
    assert r["hidden_mean"] > chip_smoke.SSM_MEAN_ERR
