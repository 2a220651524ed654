"""The port's CUDA kernels against their plain versions, on the card.

Run where there is a CUDA card (an H100: the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.  Only torch is imported, so the file
also runs where JAX is not installed.  Tolerances: sums at rtol 1e-5 with an
atol of 1e-5 times the largest entry (float32 sums in other orders); noise at
1e-5 sigma per element (float32 log/cos/sin/sqrt rounding); dp_aggregate with a
row gate (NaN in the rows gated off) and row ids against the plain version
at the same sum tolerance, and bit for bit where the same sums are taken in
the same order (an all-on gate or the identity row ids against neither, a
gathered block's noise against the dense noise's rows).  Flash attention on
the float32 tensor-core kernel (float32, Dh <= 256) against its 3xTF32 order
(chip_smoke.f32_reference) and against attention_ref, and on the SIMT kernel
(called by name, float32 or bfloat16) against attention_ref: float32 at rtol
1e-5 and atol 1e-5 (float32 sums in other orders); bfloat16
at rtol 2^-7, one bfloat16 ulp (both sides compute in float32 and round once),
with atol 1e-4 for outputs near zero.  On the tensor-core kernel (bfloat16,
Dh <= 256) against attention_tc_ref at its key tile (128 keys up to Dh 128,
64 above), its rounding order: the same bfloat16 tolerance
plus one bf16 ulp of a row's largest p (chip_smoke.tc_reference: a p next to
a rounding boundary may round the other way); against attention_ref within
the P-rounding bounds chip_smoke.py derives (P_MAX, P_MEAN).  The SSD scan in float32
against the recurrence, the chunked SSD and the plain function in the
kernels' order at rtol 1e-5 with an atol of 1e-5 times the largest entry (the
chunked dual form against products of per-step decays, its products as
3xTF32 on the tensor cores: float32 sums in other orders).  The chunked
dp_aggregate wrapper against one launch and its plain version at the sum
tolerance; a streamed run on the card against the CPU at rtol 1e-4 (float32
sums in other orders, amplified by the FedEXP ratio over four rounds); a
host source staged through pinned memory at prefetch 1 and 3 against the
device-resident stream in bits.  Compression: the sketch twice in bits and
against the CPU at the sum tolerance, ``topk_select`` on tied integers equal
to the CPU's, a compressed run twice in bits with no dp_aggregate launch.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.aggregation import fused_clip_aggregate  # noqa: E402
from repro_torch.kernels.dp_aggregate import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref, ssd_scan_stages_ref  # noqa: E402
from repro_torch.models.ssm import _final_state, ssd_chunked  # noqa: E402

pytestmark = pytest.mark.cuda
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# the last two widths are the paper's CNNs' (d = 237 LDP, fused mode; d = 5046 CDP, none
# mode) at the e2 workload's M = 1000
DP_SHAPES = [(1, 1), (37, 129), (1000, 500), (300, 4099), (1000, 131072), (8, 300001),
             (1000, 237), (1000, 5046)]


def _dp_inputs(m, d, dev):
    g = torch.Generator(device=dev).manual_seed(m + d)
    u = torch.randn(m, d, generator=g, device=dev) * torch.rand(m, 1, generator=g, device=dev)
    return u * (2 / d**0.5), 0.3 * torch.randn(m, d, generator=g, device=dev)


@pytest.mark.parametrize("m,d", DP_SHAPES)
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_kernel_matches_plain(dev, m, d, mode):
    """Every mode at every shape (the last takes the L2 path); one launch a call."""
    u, noise = _dp_inputs(m, d, dev)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    plain_noise = {"operand": noise,
                   "fused": ref.ldp_noise_ref(m, d, 42, 0.3, device=dev)}.get(mode)
    before = ops.dp_aggregate_sums.launches
    got = ops.dp_aggregate_sums(u, 0.5, **kw)
    assert ops.dp_aggregate_sums.launches == before + 1
    for a, b in zip(got, ref.dp_aggregate_ref(u, plain_noise, 0.5)):
        _close(a, b)


@pytest.mark.parametrize("m,d", DP_SHAPES)
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_a_device_clip_gives_the_float_clips_bits(dev, m, d, mode):
    """C as a 0-d float32 tensor on the card (adaptive clipping): the kernel
    reads it there; its bits equal the float-C launch's and it matches the
    plain version fed the same tensor; a C twice as large does not."""
    u, noise = _dp_inputs(m, d, dev)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    plain_noise = {"operand": noise,
                   "fused": ref.ldp_noise_ref(m, d, 42, 0.3, device=dev)}.get(mode)
    clip = torch.full((), 0.5, device=dev)
    before = ops.dp_aggregate_sums.launches
    got = ops.dp_aggregate_sums(u, clip, **kw)
    assert ops.dp_aggregate_sums.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ops.dp_aggregate_sums(u, 0.5, **kw)))
    for a, b in zip(got, ref.dp_aggregate_ref(u, plain_noise, clip)):
        _close(a, b)
    doubled = ops.dp_aggregate_sums(u, 2 * clip, **kw)
    clipped = bool((torch.linalg.vector_norm(u, dim=1) > 0.5).any())
    assert torch.equal(doubled[2], got[2]) != clipped   # the clipped squares move with C


def test_a_device_clip_must_lie_on_the_updates_device(dev):
    u = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="lies on cpu"):
        ops.dp_aggregate_sums(u, torch.tensor(1.0))
    with pytest.raises(ValueError, match="0-d float32"):
        ops.dp_aggregate_sums(u, torch.ones(1, device=dev))


@pytest.mark.parametrize("m,d", [(37, 129), (1000, 131072), (8, 300001)])
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_two_launches_give_identical_bits(dev, m, d, mode):
    u, noise = _dp_inputs(m, d, dev)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=3, noise_sigma=0.7)}.get(mode, {})
    a = ops.dp_aggregate_sums(u, 0.5, **kw)
    b = ops.dp_aggregate_sums(u, 0.5, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("m,d", [(40, 129), (300, 4099), (20, 300001)])
def test_fused_rows_keep_their_noise_under_row_start(dev, m, d):
    """A slice of the cohort keyed by its global rows draws the whole cohort's
    noise: it matches the plain version, and two halves sum to the whole."""
    u, _ = _dp_inputs(m, d, dev)
    kw = dict(noise_seed=9, noise_sigma=0.4)
    h = m // 3
    hi = ops.dp_aggregate_sums(u[h:], 1.0, row_start=h, **kw)
    plain = ref.dp_aggregate_ref(u[h:], ref.ldp_noise_ref(m, d, 9, 0.4, device=dev)[h:], 1.0)
    for a, b in zip(hi, plain):
        _close(a, b)
    whole, lo = ops.dp_aggregate_sums(u, 1.0, **kw), ops.dp_aggregate_sums(u[:h], 1.0, **kw)
    for w, a, b in zip(whole, lo, hi):
        _close(a + b, w)


def test_a_smaller_shape_leaves_a_larger_ones_launch_intact(dev):
    """Each shape's plan asks for its own shared memory; a smaller one planned
    later must not lower the kernel's limit under a larger one."""
    big, small = torch.randn(1000, 500, device=dev), torch.randn(1, 1, device=dev)
    want = ops.dp_aggregate_sums(big, float("inf"))
    ops.dp_aggregate_sums(small, 1.0)
    ops.launch_plan(3, 7, "none", dev)
    got = ops.dp_aggregate_sums(big, float("inf"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("m,d,row_start", [(64, 300, 0), (64, 300, 999), (5, 4099, 7),
                                           (3, 1, 0), (1000, 131072, 0), (2, 300001, 5)])
def test_noise_kernel_matches_plain_generator(dev, m, d, row_start):
    before = ops.generate_ldp_noise.launches
    k = ops.generate_ldp_noise(m, d, 7, 1.5, device=dev, row_start=row_start)
    assert ops.generate_ldp_noise.launches == before + 1
    p = ref.ldp_noise_ref(m, d, 7, 1.5, device=dev, row_start=row_start)
    assert float((k - p).abs().max()) <= 1e-5 * 1.5
    if m * d < 10**6:
        c = ref.ldp_noise_ref(m, d, 7, 1.5, row_start=row_start)   # the CPU's plain version
        assert float((k.cpu() - c).abs().max()) <= 1e-5 * 1.5


@pytest.mark.parametrize("m,d", [(200, 1000), (33, 4099), (8, 300001)])
def test_fused_is_deterministic_and_equals_operand_fed_the_noise_kernel(dev, m, d):
    u = torch.randn(m, d, device=dev)
    a = ops.dp_aggregate_sums(u, 1.0, noise_seed=5, noise_sigma=0.8)
    b = ops.dp_aggregate_sums(u, 1.0, noise_seed=5, noise_sigma=0.8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ops.dp_aggregate_sums(u, 1.0, ops.generate_ldp_noise(m, d, 5, 0.8, device=dev))
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


def _gate(m, dev, frac, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    gate = (torch.rand(m, generator=g, device=dev) < frac).to(torch.float32)
    return gate * torch.randint(1, 3, (m,), generator=g, device=dev)   # values > 0 enter once


@pytest.mark.parametrize("m,d", DP_SHAPES)
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_gated_kernel_matches_plain_with_nan_in_gated_off_rows(dev, m, d, mode):
    """~10% of the rows on (multiplicities 1 or 2, each entering once), NaN
    planted in the rows gated off: the plain version's sums."""
    u, noise = _dp_inputs(m, d, dev)
    gate = _gate(m, dev, 0.1)
    gate[0] = 1.0
    u[gate == 0] = float("nan")
    noise[gate == 0] = float("inf")
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    plain_noise = {"operand": noise,
                   "fused": ref.ldp_noise_ref(m, d, 42, 0.3, device=dev)}.get(mode)
    before = ops.dp_aggregate_sums.launches
    got = ops.dp_aggregate_sums(u, 0.5, row_gate=gate, **kw)
    assert ops.dp_aggregate_sums.launches == before + 1
    for a, b in zip(got, ref.dp_aggregate_ref(u, plain_noise, 0.5, row_gate=gate)):
        assert torch.isfinite(a).all()
        _close(a, b)


@pytest.mark.parametrize("m,d", DP_SHAPES)
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_all_on_gate_gives_the_ungated_bits_and_all_off_gives_zero(dev, m, d, mode):
    u, noise = _dp_inputs(m, d, dev)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    want = ops.dp_aggregate_sums(u, 0.5, **kw)
    on = ops.dp_aggregate_sums(u, 0.5, row_gate=torch.ones(m, device=dev), **kw)
    ids = ops.dp_aggregate_sums(u, 0.5, row_ids=torch.arange(m, device=dev), **kw)
    assert all(torch.equal(a, b) for a, b in zip(on, want))
    assert all(torch.equal(a, b) for a, b in zip(ids, want))
    off = ops.dp_aggregate_sums(u.fill_(float("nan")), 0.5, row_gate=torch.zeros(m, device=dev),
                                **kw)
    assert all(bool((x == 0).all()) for x in off)


@pytest.mark.parametrize("m,d", [(40, 129), (300, 4099), (1000, 131072), (20, 300001)])
def test_row_ids_draw_the_gathered_clients_rows_of_the_dense_noise(dev, m, d):
    """A gathered block (slots with two padding slots at client 0, gated off)
    draws its clients' rows of the dense noise, bit for bit, in the noise-only
    kernel and in fused mode; row_start + row in their place fails."""
    g = torch.Generator(device=dev).manual_seed(7)
    cap = max(3, m // 8)                 # at least one client besides the two padding slots
    slots = torch.sort(torch.randperm(m, generator=g, device=dev)[:cap - 2]).values
    slots = torch.cat([slots, torch.zeros(2, dtype=slots.dtype, device=dev)])
    gate = torch.cat([torch.ones(cap - 2, device=dev), torch.zeros(2, device=dev)])
    dense = ops.generate_ldp_noise(m, d, 5, 0.8, device=dev)
    block = ops.generate_ldp_noise(cap, d, 5, 0.8, device=dev, row_ids=slots)
    assert torch.equal(block, dense[slots])
    u, _ = _dp_inputs(m, d, dev)
    ub = u[slots]
    fused = ops.dp_aggregate_sums(ub, 1.0, noise_seed=5, noise_sigma=0.8, row_gate=gate,
                                  row_ids=slots)
    operand = ops.dp_aggregate_sums(ub, 1.0, dense[slots], row_gate=gate)
    for a, b in zip(fused, operand):
        _close(a, b)
    dense_gate = torch.zeros(m, device=dev)
    dense_gate[slots[:cap - 2]] = 1.0
    whole = ops.dp_aggregate_sums(u, 1.0, noise_seed=5, noise_sigma=0.8, row_gate=dense_gate)
    for a, b in zip(fused, whole):
        _close(a, b)
    wrong = ops.dp_aggregate_sums(ub, 1.0, noise_seed=5, noise_sigma=0.8, row_gate=gate)
    assert not torch.allclose(wrong[0], fused[0], rtol=1e-5,
                              atol=1e-5 * float(fused[0].abs().max()))


def test_masked_moments_are_one_launch_on_the_card(dev):
    """partial_clip_moments with a mask, and a gathered block's seed noise,
    take one dp_aggregate launch and no plain fallback; the CPU agrees."""
    from repro_torch.core.aggregation import partial_clip_moments, raw_moments
    u, _ = _dp_inputs(64, 300, dev)
    mask = _gate(64, dev, 0.3)
    slots = torch.tensor([3, 9, 20, 0])
    for kw in (dict(), dict(noise_seed=3, noise_sigma=0.5),
               dict(noise_seed=3, noise_sigma=0.5, start=slots)):
        rows = u[slots.to(dev)] if "start" in kw else u
        gate = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) if "start" in kw else mask
        before = ops.dp_aggregate_sums.launches
        got = partial_clip_moments(rows, 0.7, weight_mask=gate, **kw)
        assert ops.dp_aggregate_sums.launches == before + 1
        want = partial_clip_moments(rows.cpu(), 0.7, weight_mask=gate.cpu(), **kw)
        for f in ("sum_c", "sum_sq", "sum_sq_clipped", "count"):
            _close(getattr(got, f), torch.as_tensor(getattr(want, f)))
    binary = (mask > 0).to(torch.float32)
    before = ops.dp_aggregate_sums.launches
    got = raw_moments(u, binary, binary_mask=True)
    assert ops.dp_aggregate_sums.launches == before + 1
    want = raw_moments(u.cpu(), binary.cpu())
    for f in ("sum_c", "sum_sq", "count"):
        _close(getattr(got, f), torch.as_tensor(getattr(want, f)))


@pytest.mark.parametrize("kind", ["dense", "gathered", "replace"])
@pytest.mark.parametrize("central", [False, True], ids=["ldp", "cdp"])
def test_a_dp_scaffold_round_is_two_launches_and_equals_the_cpu(dev, central, kind):
    """One dp-scaffold round on the card, dense, over a gathered slot table
    (sampled_round: the hook hands the block its variate rows) or over a
    cohort drawn with replacement (each draw a row of its own), against the
    same round on the CPU fed the same noise: its two releases are two
    dp_aggregate launches and no plain sum."""
    from repro_torch.core.algorithm import RoundNoise
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.core.variance_reduction import ScaffoldState
    from repro_torch.fedsim import CohortSpec
    from repro_torch.fedsim.server import sampled_round
    m, d = 64, 300
    alg = make_algorithm("dp-scaffold", clip_norm=0.3, sigma=0.2, central=central,
                         num_clients=m, tau=5, eta_l=0.3)
    u, _ = _dp_inputs(m, d, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    c, c_is = (0.1 * torch.randn(d, generator=g, device=dev),
               0.1 * torch.randn(m, d, generator=g, device=dev))
    z = (torch.randn(d, generator=g, device=dev), torch.randn(d, generator=g, device=dev))
    mask = torch.zeros(m)
    mask[[0, 9, 20, 41]] = torch.tensor([2.0, 1.0, 3.0, 1.0]) if kind == "replace" else 1.0
    cohort = (CohortSpec(size=7, replace=True) if kind == "replace"
              else CohortSpec(q=0.1, gather=True, gather_cap=6))

    def round_on(dv):
        noise = (RoundNoise(central=z[0].to(dv), central_dc=z[1].to(dv)) if central
                 else RoundNoise(seed=11, seed_dc=12))
        state = ScaffoldState(c=c.to(dv), c_is=c_is.to(dv))
        w = torch.zeros(d, device=dv)
        if kind == "dense":
            return alg.apply_round_stateful(None, w, u.to(dv), state, noise)
        return sampled_round(alg, lambda w_, b, eta, ctx: b["u"], w, state, noise, mask,
                             cohort, 0, {"u": u.to(dv)}, 0.3)

    before = ops.dp_aggregate_sums.launches
    got = round_on(dev)
    assert ops.dp_aggregate_sums.launches == before + 2
    want = round_on(torch.device("cpu"))
    _close(got[0], want[0])
    _close(got[2].c, want[2].c)
    _close(got[2].c_is, want[2].c_is)


@pytest.fixture
def f32_convs():
    """cuDNN convolutions in float32, not TF32 (its default), as chip_smoke.py
    sets them; restored after the test."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def _cnn_cohort(variant, m, n):
    """The CNN, a cohort of m clients with n generated images each (labels
    skewed by a Dirichlet split), and per-client weights near the init."""
    from repro_torch.data import client_image_batches, dirichlet_partition, make_image_dataset
    from repro_torch.models.cnn import make_cnn
    ds = make_image_dataset(torch.Generator().manual_seed(7), num_train=400, num_test=100)
    batches = client_image_batches(ds, dirichlet_partition(0, ds.train_y, m,
                                                           samples_per_client=n))
    model = make_cnn(torch.Generator().manual_seed(100), variant)
    ws = model.init_flat + 0.05 * torch.randn(m, model.dim, generator=torch.Generator()
                                              .manual_seed(1))
    return model, batches, ws


@pytest.mark.parametrize("variant", ["cdp", "ldp"])
def test_cnn_grads_on_the_card_equal_the_cpus(dev, f32_convs, variant):
    """vmap(grad) of the CNN loss with per-client weights (batched patch
    gathers and products) on the card against the CPU: float32 sums in other
    orders."""
    from repro_torch.models.cnn import masked_xent_loss
    model, batches, ws = _cnn_cohort(variant, 16, 12)
    grad = torch.func.vmap(torch.func.grad(masked_xent_loss(model)))
    want = grad(ws, batches)
    got = grad(ws.to(dev), {k: v.to(dev) for k, v in batches.items()})
    _close(got, want)


@pytest.mark.parametrize("spec_kw", [dict(batch_size=4, epochs=2, prox_mu=0.01, momentum=0.9),
                                     dict(momentum=0.5)], ids=["minibatch", "full-batch"])
def test_the_spec_trainer_on_the_card_equals_the_cpu(dev, f32_convs, spec_kw):
    """The card draws the CPU's shuffles in bits (integer Threefry and a
    stable sort), and trains the CNN cohort on them to the CPU's updates at
    the sum tolerance; a gathered block's shuffles are its dense rows'."""
    from repro_torch.fedsim import LocalSpec, cohort_updates_spec
    from repro_torch.fedsim.local import local_shuffles
    from repro_torch.models.cnn import masked_xent_loss
    model, batches, _ = _cnn_cohort("cdp", 16, 12)
    assert torch.equal(local_shuffles(77, torch.arange(16, device=dev), 2, 12).cpu(),
                       local_shuffles(77, torch.arange(16), 2, 12))
    slots = torch.tensor([3, 5, 11, 0])
    assert torch.equal(local_shuffles(77, slots.to(dev), 2, 12),
                       local_shuffles(77, torch.arange(16, device=dev), 2, 12)[slots.to(dev)])
    spec, loss = LocalSpec(**spec_kw), masked_xent_loss(model)
    want = cohort_updates_spec(loss, model.init_flat, batches, spec, 3, 0.1, 77)
    got = cohort_updates_spec(loss, model.init_flat.to(dev),
                              {k: v.to(dev) for k, v in batches.items()}, spec, 3, 0.1, 77)
    _close(got, want)


def test_cuda_tensors_never_reach_the_plain_version_silently(dev):
    with pytest.raises(ValueError, match="shape"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0, torch.zeros(4, 9, device=dev))
    with pytest.raises(ValueError, match="device"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="row_gate lies on cpu"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0, row_gate=torch.ones(4))
    with pytest.raises(ValueError, match=r"row_ids must be a \(4,\) tensor"):
        ops.dp_aggregate_sums(torch.zeros(4, 8, device=dev), 1.0,
                              row_ids=torch.arange(5, device=dev))


CHUNKED = [(1000, 500, 125), (1000, 4099, 300), (37, 129, 8), (1000, 237, 1000)]


@pytest.mark.parametrize("m,d,chunk", CHUNKED)
@pytest.mark.parametrize("mode", ["none", "operand", "fused"])
def test_chunked_wrapper_matches_one_launch_and_its_plain_version(dev, m, d, chunk, mode):
    """One launch a chunk (the last ragged), gated by the row gate; with slots
    one gated launch a chunk of the slot table, keyed by the slots."""
    u, noise = _dp_inputs(m, d, dev)
    gate = _gate(m, dev, 0.3)
    kw = {"operand": dict(noise=noise), "fused": dict(noise_seed=42, noise_sigma=0.3)}.get(mode, {})
    before = (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches)
    got = ops.dp_aggregate_sums_chunked(u, 0.5, chunk_m=chunk, row_gate=gate, **kw)
    n = -(-m // chunk)
    assert (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches) == (
        before[0] + n, before[1] + n)
    one = ops.dp_aggregate_sums(u, 0.5, row_gate=gate, **kw)
    plain = ref.dp_aggregate_sums_chunked_ref(u, 0.5, chunk_m=chunk, row_gate=gate, **kw)
    for a, b, c in zip(got, one, plain):
        _close(a, b)
        _close(a, c)
    on = torch.nonzero(gate.cpu() > 0).flatten()
    cap = -(-(on.numel() + 3) // chunk) * chunk
    slots = torch.zeros(cap, dtype=torch.int64)
    slots[:on.numel()] = on
    slot_mask = torch.zeros(cap)
    slot_mask[:on.numel()] = 1.0
    slots, slot_mask = slots.to(dev), slot_mask.to(dev)
    skw = {"operand": dict(noise=noise.index_select(0, slots))}.get(mode, kw)
    got = ops.dp_aggregate_sums_chunked(u, 0.5, chunk_m=chunk, slots=slots, slot_mask=slot_mask,
                                        **skw)
    plain = ref.dp_aggregate_sums_chunked_ref(u, 0.5, chunk_m=chunk, slots=slots,
                                              slot_mask=slot_mask, **skw)
    for a, b, c in zip(got, one, plain):
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize("m,d,chunk", [(37, 129, 8), (1000, 4099, 300)])
@pytest.mark.parametrize("mode", ["none", "fused"])
def test_chunked_wrapper_gates_the_padding_of_an_ungated_call(dev, m, d, chunk, mode):
    """Without a row gate only the padded last chunk is a gated launch, its
    padding off: the sums are the ungated launch's."""
    u, _ = _dp_inputs(m, d, dev)
    kw = dict(noise_seed=42, noise_sigma=0.3) if mode == "fused" else {}
    before = (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches)
    got = ops.dp_aggregate_sums_chunked(u, 0.5, chunk_m=chunk, **kw)
    assert (ops.dp_aggregate_sums.launches, ops.dp_aggregate_sums.gated_launches) == (
        before[0] + -(-m // chunk), before[1] + 1)
    one = ops.dp_aggregate_sums(u, 0.5, **kw)
    plain = ref.dp_aggregate_sums_chunked_ref(u, 0.5, chunk_m=chunk, **kw)
    for a, b, c in zip(got, one, plain):
        _close(a, b)
        _close(a, c)


def _stream_session(dev, name, batches, **kw):
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.fedsim import EngineSpec, FederatedSession, StreamSpec, TrainSpec
    m, d = 44, 24
    alg = {"ldp-fedexp-gauss": dict(clip_norm=0.3, sigma=0.21), "fedexp": {}}[name]

    def loss(w, b):
        return 0.5 * torch.sum(torch.square(w - b["t"]))

    return FederatedSession(make_algorithm(name, **alg), loss, torch.zeros(d), batches,
                            train=TrainSpec(rounds=4, tau=2, eta_l=0.5),
                            engine=EngineSpec(engine="stream"), stream=StreamSpec(16),
                            device=dev, **kw)


def _stream_rows():
    g = torch.Generator().manual_seed(8)
    return {"t": torch.randn(44, 24, generator=g)}


@pytest.mark.parametrize("name", ["ldp-fedexp-gauss", "fedexp"])
@pytest.mark.parametrize("gather", [False, True])
def test_a_streamed_run_on_the_card_equals_the_cpu(dev, name, gather):
    """The LDP noise is keyed by (seed, client) on both; a CDP name's (d,)
    normal is drawn by the card's generator on the card, so it is left out,
    as phase 5 leaves it out."""
    from repro_torch.fedsim import CohortSpec
    cohort = CohortSpec(q=0.4, gather=True) if gather else None
    rows = _stream_rows()
    before = ops.dp_aggregate_sums.launches
    got = _stream_session(dev, name, {"t": rows["t"].to(dev)}, cohort=cohort).run(3)
    want = _stream_session("cpu", name, rows, cohort=cohort).run(3)
    chunks = -(-44 // 16) if not gather else -(-cohort.resolved_cap(44) // 16)
    assert ops.dp_aggregate_sums.launches == before + 4 * chunks
    for f in ("final_w", "eta_history"):
        a, b = getattr(got, f).double().cpu(), getattr(want, f).double()
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("gather", [False, True])
def test_pinned_prefetch_gives_the_device_resident_bits(dev, gather):
    from repro_torch.fedsim import CohortSpec, DataSpec, HostArraySource
    cohort = CohortSpec(q=0.4, gather=True) if gather else None
    rows = _stream_rows()
    want = _stream_session(dev, "ldp-fedexp-gauss", {"t": rows["t"].to(dev)},
                           cohort=cohort).run(3)
    for prefetch in (1, 3):
        got = _stream_session(dev, "ldp-fedexp-gauss", HostArraySource(rows), cohort=cohort,
                              data=DataSpec(kind="host", prefetch=prefetch)).run(3)
        assert torch.equal(got.final_w, want.final_w)
        assert torch.equal(got.eta_history, want.eta_history)


FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2**-7, atol=1e-4)}
FLASH_CASES = {  # b, hq, hkv, sq, skv, dh, causal, window, kv_len
    "gqa-dh120": (2, 8, 2, 200, 200, 120, True, None, None),
    "window": (1, 4, 1, 300, 300, 120, True, 64, None),
    "mqa-dh256": (1, 8, 1, 130, 130, 256, True, None, None),
    "ragged-kv-len-noncausal": (2, 4, 2, 77, 150, 64, False, None, 101),
    "dh200-window-noncausal": (1, 2, 2, 90, 90, 200, False, 40, None),
    "dh32-one-row": (1, 2, 1, 1, 1, 32, True, None, None),
    "dh80-zamba2": (1, 8, 2, 333, 333, 80, True, None, None),
    "dh128-granite": (2, 8, 2, 300, 300, 128, True, None, None),
    "mqa-sq-under-one-tile": (2, 8, 1, 50, 200, 64, False, None, None),
    "ragged-sq-skv-kv-len": (1, 4, 2, 130, 257, 120, False, None, 250),
    "window-under-one-tile": (1, 4, 1, 400, 400, 120, True, 37, None),
    "one-row-query-long-keys": (2, 4, 2, 1, 300, 120, False, None, 299),
    "noncausal-window-dh64": (1, 4, 2, 300, 300, 64, False, 50, None),
    # the tensor-core kernel's 64-key instances (Dh > 128) in bf16
    "gqa-dh136-window": (2, 8, 2, 300, 300, 136, True, 100, None),
    "dh192-ragged-kv-len-noncausal": (1, 4, 2, 190, 257, 192, False, None, 201),
    "mqa-dh256-ragged-sq": (2, 8, 1, 333, 333, 256, True, None, None),
    "mqa-dh256-window-under-one-tile": (1, 8, 1, 300, 300, 256, True, 37, None),
}


def _tc_close(got, q, k, v, **kw):
    """chip_smoke.py's checks of the tensor-core kernel: tight against its
    rounding order, and within the P-rounding bounds of attention_ref."""
    want, flip = chip_smoke.tc_reference(q, k, v, **kw)
    chip_smoke.flash_close(got, want, "tensor-core kernel vs attention_tc_ref", flip)
    chip_smoke.p_rounding(got, attention_ref(q, k, v, **kw), v,
                          "tensor-core kernel vs attention_ref")


def _f32_close(got, q, k, v, **kw):
    """chip_smoke.py's checks of the float32 tensor-core kernel: within
    FLASH_TOL of its 3xTF32 order (tight) and of attention_ref."""
    chip_smoke.flash_close(got, chip_smoke.f32_reference(q, k, v, **kw),
                           "float32 tensor-core kernel vs its 3xTF32 order")
    chip_smoke.flash_close(got, attention_ref(q, k, v, **kw),
                           "float32 tensor-core kernel vs attention_ref")


def _qkv(dev, dtype, b, hq, hkv, sq, skv, dh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, case, dtype):
    b, hq, hkv, sq, skv, dh, causal, window, kv_len = FLASH_CASES[case]
    q, k, v = _qkv(dev, dtype, b, hq, hkv, sq, skv, dh)
    fa = flash_ops.flash_attention
    kernel = "tc" if dtype == torch.bfloat16 else "f32"   # every case has Dh <= 256
    wide = kernel == "tc" and dh > 128
    counters = ("launches", "launches_tc", "launches_tc_wide", "launches_f32", "launches_simt")
    before = [getattr(fa, c) for c in counters]
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = fa(q, k, v, **kw)
    assert [getattr(fa, c) - n for c, n in zip(counters, before)] == [
        1, kernel == "tc", wide, kernel == "f32", 0]
    assert got.dtype == dtype and got.shape == q.shape
    if kernel == "tc":
        _tc_close(got, q, k, v, **kw)
    else:
        _f32_close(got, q, k, v, **kw)
        assert torch.equal(got, flash_ops.f32_kernel(q, k, v, **kw))


def _deterministic_on_strided_views(dev, launch, dtype, dh=120, hkv=2):
    b, s, hq = 2, 257, 8
    g = torch.Generator(device=dev).manual_seed(3)
    # the model's layout: (B, S, H, Dh), handed over as (B, H, S, Dh) views
    q = torch.randn(b, s, hq, dh, generator=g, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, hkv, dh, generator=g, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, hkv, dh, generator=g, device=dev).to(dtype).transpose(1, 2)
    a = launch(q, k, v, causal=True, window=100)
    again = launch(q, k, v, causal=True, window=100)
    assert torch.equal(a, again)
    dense = launch(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=100)
    assert torch.equal(a, dense)
    assert a.transpose(1, 2).is_contiguous()   # out in q's layout: no copy back


def test_flash_kernel_is_deterministic_and_takes_strided_views(dev):
    _deterministic_on_strided_views(dev, flash_ops.tc_kernel, torch.bfloat16)


@pytest.mark.parametrize("dh,hkv", [(136, 2), (192, 2), (256, 1)])
def test_wide_tc_kernel_is_deterministic_and_takes_strided_views(dev, dh, hkv):
    """The 64-key instances on the model's transposed views, MQA at Dh 256
    (gemma-2b's one KV head: a size-1 head axis)."""
    _deterministic_on_strided_views(dev, flash_ops.tc_kernel, torch.bfloat16, dh, hkv)


@pytest.mark.parametrize("dh", [136, 192, 256])
@pytest.mark.parametrize("causal,window,kv_len", [(True, None, None), (True, 100, None),
                                                  (False, None, 700), (False, 64, 901)])
def test_wide_tc_kernel_matches_its_rounding_order(dev, dh, causal, window, kv_len):
    """Dh in (128, 256], GQA 8/2 with a ragged last query tile and key tile
    (Sq = Skv = 1000), causal or not, a window or not, a ragged kv_len; the
    dispatch counts it as a 64-key launch; two launches give the same bits."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 8, 2, 1000, 1000, dh, seed=dh)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    fa = flash_ops.flash_attention
    before = (fa.launches_tc_wide, fa.launches_simt)
    got = fa(q, k, v, **kw)
    assert (fa.launches_tc_wide - before[0], fa.launches_simt - before[1]) == (1, 0)
    _tc_close(got, q, k, v, **kw)
    assert torch.equal(got, flash_ops.tc_kernel(q, k, v, **kw))


def test_the_librarys_key_tile_is_the_wrappers(dev):
    lib = flash_ops.load_library_tc()
    for dh in (8, 64, 120, 128, 136, 192, 200, 256):
        assert lib.flash_attention_tc_keys(dh) == flash_ops.tc_block_k(dh)
    assert [lib.flash_attention_tc_keys(dh) for dh in (0, 100, 264)] == [0, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_simt_kernel_is_deterministic_and_takes_strided_views(dev, dtype):
    _deterministic_on_strided_views(dev, flash_ops.simt_kernel, dtype)


@pytest.mark.parametrize("dh,hkv", [(120, 2), (64, 2), (136, 2), (192, 2), (256, 1), (99, 2)])
def test_f32_kernel_is_deterministic_and_takes_strided_views(dev, dh, hkv):
    """The float32 tensor-core kernel on the model's transposed views at every
    instance (Dh 64, 120, 136/192, 256), MQA at Dh 256, and Dh 99 (4-byte
    loads)."""
    _deterministic_on_strided_views(dev, flash_ops.f32_kernel, torch.float32, dh, hkv)


@pytest.mark.parametrize("dh", [64, 80, 100, 120, 136, 192, 256])
@pytest.mark.parametrize("causal,window,kv_len", [(True, None, None), (True, 37, None),
                                                  (False, None, 700), (False, 64, 901)])
def test_f32_kernel_matches_its_3xtf32_order(dev, dh, causal, window, kv_len):
    """Phase 2b's float32 cases: GQA 8/2 with a ragged last query tile and key
    tile (Sq = Skv = 1000), causal or not, a window under a tile or not, a
    ragged kv_len; through the dispatch, one float32 tensor-core launch."""
    q, k, v = _qkv(dev, torch.float32, 2, 8, 2, 1000, 1000, dh, seed=dh)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    fa = flash_ops.flash_attention
    before = (fa.launches_f32, fa.launches_simt, fa.launches_tc)
    got = fa(q, k, v, **kw)
    assert (fa.launches_f32 - before[0], fa.launches_simt - before[1],
            fa.launches_tc - before[2]) == (1, 0, 0)
    _f32_close(got, q, k, v, **kw)


@pytest.mark.parametrize("shape,window,fault", [
    ((2, 32, 8, 8192, 120), 4096, dict(window=4097)),
    ((2, 8, 1, 8176, 256), None, dict(window=4096)),
], ids=["h2o", "gemma"])
def test_f32_kernel_matches_its_3xtf32_order_at_the_serve_shapes(dev, shape, window, fault):
    """The float32 prefills' attention at h2o-danube-3-4b's and gemma-2b's
    shapes, with the planted fault of phase 2b that the tight check must see."""
    b, hq, hkv, s, dh = shape
    q, k, v = _qkv(dev, torch.float32, b, hq, hkv, s, s, dh, seed=7)
    got = flash_ops.f32_kernel(q, k, v, causal=True, window=window)
    _f32_close(got, q, k, v, causal=True, window=window)
    _, ratio = chip_smoke.flash_excess(got, chip_smoke.f32_reference(
        q, k, v, causal=True, **{"window": window, **fault}))
    assert ratio > 1


def test_the_f32_librarys_key_tile_is_the_wrappers(dev):
    lib = flash_ops.load_library_f32()
    for dh in (1, 8, 64, 99, 120, 128, 129, 136, 192, 193, 256):
        assert lib.flash_attention_f32_keys(dh) == flash_ops.f32_block_k(dh)
    assert [lib.flash_attention_f32_keys(dh) for dh in (0, 257)] == [0, 0]


def test_flash_dispatch_follows_the_rule_and_refuses_misaligned_views(dev):
    fa = flash_ops.flash_attention
    for dtype, dh, kernel in ((torch.bfloat16, 120, "tc"), (torch.bfloat16, 256, "tc"),
                              (torch.bfloat16, 136, "tc"), (torch.float32, 256, "f32"),
                              (torch.float32, 120, "f32"), (torch.float32, 99, "f32")):
        q, k, v = _qkv(dev, dtype, 1, 2, 1, 64, 64, dh)
        before = (fa.launches_tc, fa.launches_f32, fa.launches_simt)
        fa(q, k, v)
        assert (fa.launches_tc - before[0], fa.launches_f32 - before[1],
                fa.launches_simt - before[2]) == ((1, 0, 0) if kernel == "tc" else (0, 1, 0))
    wide = torch.zeros(1, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError, match="aligned"):       # base 2 bytes off
        fa(wide[..., 1:121], wide[..., 1:121], wide[..., 1:121])
    padded = torch.zeros(1, 2, 64, 124, device=dev, dtype=torch.bfloat16)[..., :120]
    with pytest.raises(ValueError, match="multiples of 8"):  # row stride 124
        fa(padded, padded, padded)
    assert fa.launches == before   # nothing else was tried
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.tc_kernel(wide.float(), wide.float(), wide.float())
    with pytest.raises(TypeError, match="float32"):
        flash_ops.f32_kernel(wide, wide, wide)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(dev, dtype, 1, 2, 1, 5, 7, 64)
        assert torch.equal(fa(q, k, v, causal=False, kv_len=0), torch.zeros_like(q))


def test_tc_kernel_matches_its_rounding_order_at_the_serve_shape(dev):
    """The h2o-danube-3-4b prefill's attention, every head, and a planted
    fault (the window one too wide) that the tight check must see."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 32, 8, 8192, 8192, 120, seed=7)
    got = flash_ops.tc_kernel(q, k, v, causal=True, window=4096)
    _tc_close(got, q, k, v, causal=True, window=4096)
    assert torch.equal(got, flash_ops.tc_kernel(q, k, v, causal=True, window=4096))
    _, fault = chip_smoke.flash_excess(got, *chip_smoke.tc_reference(q, k, v, causal=True,
                                                                      window=4097))
    assert fault > 1


def test_wide_tc_kernel_matches_its_rounding_order_at_gemmas_shape(dev):
    """The gemma-2b prefill's attention (8 query heads, one KV head of 256,
    8176 rows: a ragged last query tile) and a planted fault (a window of
    4096, chip_smoke.py's phase-8 fault) that the tight check must see."""
    q, k, v = _qkv(dev, torch.bfloat16, 2, 8, 1, 8176, 8176, 256, seed=8)
    got = flash_ops.tc_kernel(q, k, v, causal=True)
    _tc_close(got, q, k, v, causal=True)
    assert torch.equal(got, flash_ops.tc_kernel(q, k, v, causal=True))
    _, fault = chip_smoke.flash_excess(got, *chip_smoke.tc_reference(
        q, k, v, causal=True, window=chip_smoke.GEMMA_FAULT_WINDOW))
    assert fault > 1


def test_flash_kernel_refuses_what_it_cannot_run(dev):
    q = torch.zeros(1, 2, 8, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_ops.flash_attention(q, q, q)
    big = torch.zeros(1, 1, 8, 264, device=dev)
    with pytest.raises(ValueError, match="Dh <="):
        flash_ops.flash_attention(big, big, big)
    x = torch.zeros(1, 2, 8, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_ops.flash_attention(x, x, x)


SSD_CASES = {  # b, s, h, p, n: one chunk, ragged, partial P slices and odd N, serve-like,
    # and a sequence one step short of the kernels' chunk, one chunk, one step over
    # (N 64: zamba2's state)
    "s64": (1, 64, 2, 16, 8),
    "ragged-s300": (2, 300, 3, 64, 128),
    "ragged-s1237-p40-n20": (1, 1237, 2, 40, 20),
    "serve-like-s2048": (2, 2048, 8, 64, 128),
    **{f"chunk-edge-s{s}-n64": (2, s, 3, 64, 64)
       for s in (ssd_ops.CHUNK - 1, ssd_ops.CHUNK, ssd_ops.CHUNK + 1)},
}
SSD_EDGE_CASES = {  # b, s, h, p, n at the kernels' chunk edges: ragged P (P 72: a full
    # and a partial 64-column slice, P 6: not a multiple of 4) and N
    **{f"s{ssd_ops.CHUNK + e}-p72": (1, ssd_ops.CHUNK + e, 2, 72, 64) for e in (-1, 0, 1)},
    "p6-n5": (2, 3 * ssd_ops.CHUNK + 5, 2, 6, 5),
}


def _ssd_inputs(dev, b, s, h, p, n, seed=0):
    """Inputs drawn as Mamba2 initialises A and dt, so the state carries."""
    return chip_smoke.ssd_inputs(b, s, h, p, n, dev, seed)


def test_ssd_kernel_gives_a_zero_state_for_no_steps(dev):
    x, dt, a, bm, cm = _ssd_inputs(dev, 2, 0, 3, 16, 8)
    y, state = ssd_ops.ssd_scan(x, dt, a, bm, cm, return_state=True)
    assert y.shape == (2, 0, 3, 16) and torch.equal(state, torch.zeros(2, 3, 8, 16, device=dev))


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_kernel_matches_both_plain_versions(dev, case):
    args = _ssd_inputs(dev, *SSD_CASES[case])
    before = ssd_ops.ssd_scan.launches
    y, state = ssd_ops.ssd_scan(*args, return_state=True)
    assert ssd_ops.ssd_scan.launches == before + 1
    want, want_state = ssd_scan_ref(*args, return_state=True)
    _close(y, want)
    _close(state, want_state)
    _close(y, ssd_chunked(*args))
    _close(state, _final_state(*args[:4]))


@pytest.mark.parametrize("case", list(SSD_EDGE_CASES))
def test_ssd_kernel_matches_at_the_chunk_edges(dev, case):
    """The kernels at their chunk's edges against the recurrence and the
    plain function in the kernels' order."""
    args = _ssd_inputs(dev, *SSD_EDGE_CASES[case], seed=2)
    y, state = ssd_ops.ssd_scan(*args, return_state=True)
    want, want_state = ssd_scan_ref(*args, return_state=True)
    _close(y, want)
    _close(state, want_state)
    staged, staged_state = ssd_scan_stages_ref(*args, chunk=ssd_ops.CHUNK, return_state=True)
    _close(y, staged)
    _close(state, staged_state)


def test_ssd_kernel_is_deterministic_and_takes_strided_views(dev):
    b, s, h, p, n = 2, 500, 4, 64, 32
    x, dt, a, bm, cm = _ssd_inputs(dev, b, s, h, p, n, seed=1)
    # the model's layout: x, B and C are column slices of one (B, S, H*P + 2N) tensor
    packed = torch.cat([x.reshape(b, s, h * p), bm, cm], dim=-1)
    xv, bv, cv = packed.split([h * p, n, n], dim=-1)
    xv = xv.reshape(b, s, h, p)
    assert not xv.is_contiguous() and not bv.is_contiguous()
    y, state = ssd_ops.ssd_scan(xv, dt, a, bv, cv, return_state=True)
    again, again_state = ssd_ops.ssd_scan(xv, dt, a, bv, cv, return_state=True)
    assert torch.equal(y, again) and torch.equal(state, again_state)
    dense, dense_state = ssd_ops.ssd_scan(x, dt, a, bm, cm, return_state=True)
    assert torch.equal(y, dense) and torch.equal(state, dense_state)


def test_ssd_kernel_refuses_what_it_cannot_run(dev):
    x, dt, a, bm, cm = _ssd_inputs(dev, 1, 10, 2, 8, 4)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_scan(x.bfloat16(), dt, a, bm, cm)
    with pytest.raises(ValueError, match="want x"):
        ssd_ops.ssd_scan(x[0], dt, a, bm, cm)
    big = torch.zeros(1, 10, 129, device=dev)
    with pytest.raises(ValueError, match="N <="):
        ssd_ops.ssd_scan(x, dt, a, big, big)
    with pytest.raises(ValueError, match="one device"):
        ssd_ops.ssd_scan(x, dt, a.cpu(), bm, cm)
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_ops.ssd_scan(xg, dt, a, bm, cm)


# ---------------------------------------------------------------------------
# Compression: deterministic on the card
# ---------------------------------------------------------------------------

def test_the_sketch_is_the_same_in_bits_twice_and_matches_the_cpu(dev):
    """The bucket sums take a fixed order (the plan's slots), so two sketches
    of the same rows are equal in bits, where a scatter-add by atomics is
    not; against the CPU at the sum tolerance."""
    from repro_torch.core import compression as cz
    d, width = 1 << 16, 256
    plan = cz.sketch_plan(cz.plan_generator(3), d, width, 3, dev)
    rows = torch.randn(64, d, generator=torch.Generator().manual_seed(0)).to(dev)
    a, b = cz.sketch_compress(rows, plan, width), cz.sketch_compress(rows, plan, width)
    assert torch.equal(a, b)
    host = cz.SketchPlan(*(x.cpu() for x in plan))
    _close(a, cz.sketch_compress(rows.cpu(), host, width))
    dec = cz.sketch_decompress(a.sum(0), plan, d)
    assert torch.equal(dec, cz.sketch_decompress(b.sum(0), plan, d))
    _close(dec, cz.sketch_decompress(a.sum(0).cpu(), host, d))


def test_topk_select_breaks_ties_toward_the_lower_index_on_the_card(dev):
    from repro_torch.core import compression as cz
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-3, 4, (1 << 20,), generator=g).to(torch.float32)
    for k in (1, 1000, 16384, 300000):
        got = cz.topk_select(x.to(dev), k)
        want = cz.topk_select(x, k)
        assert torch.equal(got.cpu(), want) and int((got != 0).sum()) <= k


def test_a_compressed_run_on_the_card_is_deterministic_and_launches_nothing(dev):
    from repro_torch.core.compose import CountSketchAggregation, with_compression
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.fedsim import FederatedSession, TrainSpec
    d, m = 4096, 64
    t = torch.randn(m, d, generator=torch.Generator().manual_seed(2)) * d ** -0.5
    alg = with_compression(make_algorithm("cdp-fedexp", clip_norm=1.0, sigma=5e-4,
                                          num_clients=m),
                           CountSketchAggregation(width=64, depth=3, top_k=512,
                                                  error_feedback=True))

    def run():
        return FederatedSession(alg, lambda w, b: 0.5 * torch.sum((w - b["t"]) ** 2),
                                torch.zeros(d), {"t": t}, train=TrainSpec(rounds=4, tau=1,
                                                                          eta_l=0.5),
                                device=dev).run(0)
    before = ops.dp_aggregate_sums.launches
    a, b = run(), run()
    assert ops.dp_aggregate_sums.launches == before
    assert torch.equal(a.final_w, b.final_w) and torch.equal(a.eta_history, b.eta_history)
    assert torch.isfinite(a.final_w).all()


# ---------------------------------------------------------------------------
# federated LM training: the card against the CPU.  float32 with float32
# products (TF32 off), the same weights, tokens and materialized noise; the
# metrics within 1e-4 relative (float32 sums in other orders through a
# forward, a backward and the FedEXP ratio; chip_smoke.TRAIN_CHECK_TOL at full
# width).  The update tree within 1e-4 of its largest entry, or within four
# times the CPU round's own spread where that is larger: the largest change
# of the CPU's update when the weights move by float32's unit roundoff
# (2^-24 relative, two draws).  A dense round's spread is ~3e-6 of the tree,
# so 1e-4 holds it; a two-step Mamba2 round on the Markov stream amplifies a
# last-bit change of its weights to ~1e-4 of the tree (through the input
# projection, the SSD and the tied embedding; 0.9-1.0e-4 on one host, 4.7e-4
# on another), so no two float32 summation orders agree to 1e-4 there.  The bound stays under 1e-2 of the
# tree, far below a planted fault's error (eta_g forced to 1 moves it by
# 1 - 1/eta_g).
# ---------------------------------------------------------------------------

@pytest.fixture
def f32_matmuls():
    """cuBLAS products in float32, not TF32, as chip_smoke.py sets them."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _train_step_pair(dev, arch, name, impl="xla_flash"):
    """One round of ``name`` on the card and on the CPU: (card new params,
    card metrics, CPU new params, CPU metrics, the old CPU params)."""
    from repro_torch.configs import FederatedConfig, get_config, reduced
    from repro_torch.data import make_client_stream
    from repro_torch.launch import FederatedTrainer, count_params
    from repro_torch.models import DecoderLM
    cfg = reduced(get_config(arch), layers=2, d_model=256)
    card = DecoderLM(cfg, attn_impl=impl, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    cpu = DecoderLM(cfg, attn_impl=impl, device="cpu")
    cpu.load_state_dict(card.state_dict())
    fed = FederatedConfig(algorithm=name, local_steps=2, local_lr=0.05, clip_norm=0.5,
                          noise_sigma=1e-4)
    k, n = 3, count_params(cfg)
    toks = make_client_stream(torch.Generator().manual_seed(1), k, cfg.vocab_size).sample(
        torch.Generator().manual_seed(2), 2, 2, 97)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    p_cpu = {key: p.detach() for key, p in cpu.named_parameters()}
    p_card = {key: p.detach() for key, p in card.named_parameters()}
    noise = FederatedTrainer(cpu, fed, n).draw_noise(p_cpu, k, torch.Generator().manual_seed(3))
    cpu_step = FederatedTrainer(cpu, fed, n).make_train_step(k)
    want, wm = cpu_step(p_cpu, batch, None, noise)
    got, gm = FederatedTrainer(card, fed, n).make_train_step(k)(
        p_card, {key: v.to(dev) for key, v in batch.items()}, None, noise)
    spread = 0.0
    for seed in (11, 12):
        g = torch.Generator().manual_seed(seed)
        moved = {key: p * (1 + 2.0**-24 * torch.randn(p.shape, generator=g))
                 for key, p in p_cpu.items()}
        again, _ = cpu_step(moved, batch, None, noise)
        spread = max([spread] + [float(((again[key] - moved[key]) - (want[key] - p_cpu[key]))
                                       .abs().max()) for key in want])
    return got, gm, want, wm, p_cpu, spread


@pytest.mark.parametrize("name", ["fedexp", "ldp-fedexp-gauss", "cdp-fedexp"])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mamba2-2.7b"])
def test_a_train_step_on_the_card_equals_the_cpus(dev, f32_matmuls, arch, name):
    before = (ops.dp_aggregate_sums.launches, flash_ops.flash_attention.launches,
              ssd_ops.ssd_scan.launches)
    got, gm, want, wm, old, spread = _train_step_pair(dev, arch, name)
    assert (ops.dp_aggregate_sums.launches, flash_ops.flash_attention.launches,
            ssd_ops.ssd_scan.launches) == before          # training reaches no kernel
    for key in ("loss", "eta_g", "mean_update_norm", "agg_sq"):
        assert gm[key].device.type == "cuda"
        assert abs(float(gm[key]) / float(wm[key]) - 1) <= 1e-4, key
    scale = max(float((want[k] - old[k]).abs().max()) for k in want)
    bound = max(1e-4 * scale, 4 * spread)
    print(f"\n{arch} {name}: the CPU's own spread {spread / scale:.2e} of the update tree")
    assert bound <= 1e-2 * scale, (spread, scale)
    for k in want:
        err = float(((got[k].cpu() - old[k]) - (want[k] - old[k])).abs().max())
        assert err <= bound, (k, err, scale, spread)


def test_training_refuses_the_kernel_path_on_the_card(dev):
    from repro_torch.configs import FederatedConfig, get_config, reduced
    from repro_torch.launch import FederatedTrainer
    from repro_torch.models import DecoderLM
    cfg = reduced(get_config("h2o-danube-3-4b"))
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    with pytest.raises(ValueError, match="no backward"):
        FederatedTrainer(model, FederatedConfig(), 1000)
    params = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    toks = torch.zeros(1, 8, dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        model.loss(params, toks, toks)
