"""The port's CUDA kernels against their plain versions, on the card.

Run where there is a CUDA card (an H100: the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.  Only torch is imported, so the file
also runs where JAX is not installed.  Tolerances: sums at rtol 1e-5 with an
atol of 1e-5 times the largest entry (float32 sums in other orders); noise at
1e-5 sigma per element (float32 log/cos/sqrt rounding).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.aggregation import fused_clip_aggregate  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("m,d", [(1, 1), (37, 129), (1000, 500), (300, 4099)])
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_kernel_matches_plain(dev, m, d, mode):
    g = torch.Generator(device=dev).manual_seed(m + d)
    u = torch.randn(m, d, generator=g, device=dev) * torch.rand(m, 1, generator=g, device=dev)
    noise = 0.3 * torch.randn(m, d, generator=g, device=dev)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    plain_noise = {"operand": noise,
                   "fused": ref.ldp_noise_ref(m, d, 42, 0.3, device=dev)}.get(mode)
    before = ops.dp_aggregate_sums.launches
    got = ops.dp_aggregate_sums(u, 0.5, **kw)
    assert ops.dp_aggregate_sums.launches == before + 1
    for a, b in zip(got, ref.dp_aggregate_ref(u, plain_noise, 0.5)):
        _close(a, b)


@pytest.mark.parametrize("row_start", [0, 999])
def test_noise_kernel_matches_plain_generator(dev, row_start):
    k = ops.generate_ldp_noise(64, 300, 7, 1.5, device=dev, row_start=row_start)
    p = ref.ldp_noise_ref(64, 300, 7, 1.5, device=dev, row_start=row_start)
    assert float((k - p).abs().max()) <= 1e-5 * 1.5
    c = ref.ldp_noise_ref(64, 300, 7, 1.5, row_start=row_start)   # the CPU's plain version
    assert float((k.cpu() - c).abs().max()) <= 1e-5 * 1.5


def test_fused_is_deterministic_and_equals_operand_fed_the_noise_kernel(dev):
    u = torch.randn(200, 1000, device=dev)
    a = ops.dp_aggregate_sums(u, 1.0, noise_seed=5, noise_sigma=0.8)
    b = ops.dp_aggregate_sums(u, 1.0, noise_seed=5, noise_sigma=0.8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ops.dp_aggregate_sums(u, 1.0, ops.generate_ldp_noise(200, 1000, 5, 0.8, device=dev))
    for x, y in zip(a, c):
        _close(x, y)


def test_kernel_backends_agree_with_the_cpu(dev):
    u = torch.randn(50, 77)
    want = fused_clip_aggregate(u, 0.7, noise_seed=11, noise_sigma=0.2)
    for backend in ("kernel", "kernel-fused"):
        got = fused_clip_aggregate(u.to(dev), 0.7, noise_seed=11, noise_sigma=0.2,
                                   backend=backend)
        for f in ("cbar", "mean_sq", "agg_sq", "mean_sq_clipped"):
            _close(getattr(got, f), getattr(want, f))


def test_cuda_tensors_never_reach_the_plain_version_silently(dev):
    with pytest.raises(ValueError, match="shape"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0, torch.zeros(4, 9, device=dev))
    with pytest.raises(ValueError, match="device"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0, torch.zeros(4, 8))
