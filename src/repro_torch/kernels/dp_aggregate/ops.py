"""Wrappers of the dp_aggregate kernels (counterpart of repro/kernels/dp_aggregate/ops.py).

A wrapper decides by the tensor's device alone: a CPU tensor runs the plain
version in ``ref.py``; a CUDA tensor launches the hand-written kernel
(``csrc/dp_aggregate.cu``) or raises.  Each wrapper counts its kernel
launches in a plain integer attribute (``dp_aggregate_sums.launches``,
``generate_ldp_noise.launches``), which ``chip_smoke.py`` zeroes before it
drives the main path and reads after; ``dp_aggregate_sums.gated_launches``
counts the launches of the gated instance among them.

Unlike the JAX wrapper, nothing is padded: the kernel masks ragged M and d
itself.  Noise is keyed by (seed, global row, column pair), so ``row_start``
gives a slice of the cohort the rows of the whole cohort's noise, and
``row_ids`` gives any block of clients (a gathered cohort) their rows.  A
``row_gate`` keeps the rows whose gate is not > 0 out of every sum, and out
of the noise, whatever they hold: the masked-moment round of a sampled
cohort.  The aggregation is one launch whose shape (cluster size, column
window, threads, ring stages, clusters) ``_launch_plan`` computes here,
where the CPU tests reach it; ``launch_plan`` gives a card's plan, in place of
the JAX wrapper's ``pick_block_m``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path

import torch

from repro_torch.core.aggregation import RoundMoments, RoundStats
from repro_torch.kernels import _build
from repro_torch.kernels.dp_aggregate import ref

__all__ = ["LaunchPlan", "dp_aggregate", "dp_aggregate_sums", "dp_aggregate_sums_chunked",
           "generate_ldp_noise", "kernel_attributes", "launch_plan", "load_library",
           "max_active_clusters"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "dp_aggregate.cu",)

_MODES = {"none": 0, "operand": 1, "fused": 2}
_THREADS = 512               # most threads of an aggregation block
_PAIRS = (1, 2, 4, 8, 16)    # column pairs per thread the ring path is built for
_MAX_WINDOW = 2 * _PAIRS[-1] * _THREADS   # 16384 columns: the ring path's widest window
_MAX_CLUSTER = 8             # the portable cluster size
_MAX_STAGES = 4
_SMEM_BYTES = 232448 - 4096  # a block's shared memory, less the kernel's static 2304 B
_L2_PATH_BYTES = 24 << 20    # the L2 path's rows and column sums in flight (of the 50 MB L2)
_SMS = 132                   # H100 SXM


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Shape of one aggregation launch.

    ``clusters`` clusters of ``cluster`` blocks; cluster c takes rows
    [c * rows_per_cluster, (c + 1) * rows_per_cluster), block b of it the
    columns [b * window, (b + 1) * window).  ``pairs`` column pairs per
    thread in registers (0: the L2 path, no ring); the ring holds ``stages``
    row windows of ``slot_floats`` floats in ``smem_bytes`` of shared memory.
    """
    cluster: int
    window: int
    threads: int
    pairs: int
    stages: int
    slot_floats: int
    smem_bytes: int
    clusters: int
    rows_per_cluster: int


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _launch_plan(m: int, d: int, *, sms: int = _SMS, max_clusters: int | None = None
                 ) -> LaunchPlan:
    """The launch shape for an (m, d) matrix on a card of ``sms`` SMs.

    The cluster is the fewest blocks (a power of two up to 8) whose column
    windows fit the ring path; a window wider than 16384 columns (d > 131072)
    takes the L2 path.  Clusters: at most one block per SM, at most
    ``max_clusters`` (the card's occupancy for this shape), at most m, and on
    the L2 path few enough that their rows and column sums stay in L2.
    """
    k = 1
    while k < _MAX_CLUSTER and -(-d // k) > _MAX_WINDOW:
        k *= 2
    window = _round_up(-(-d // k), 4)
    pairs_needed = window // 2
    if window <= _MAX_WINDOW:
        pairs = next(p for p in _PAIRS if p * _THREADS >= pairs_needed)
        threads = _round_up(-(-pairs_needed // pairs), 32)
        slot = _round_up(window + 8, 32)   # the window and its alignment offset, 128-byte slots
        stages = min(_MAX_STAGES, _SMEM_BYTES // (4 * slot))
        smem = 4 * slot * stages
    else:
        threads, pairs, slot, stages, smem = _THREADS, 0, 0, 0, 0
    cap = sms // k if max_clusters is None else min(sms // k, max_clusters)
    if pairs == 0:
        cap = min(cap, _L2_PATH_BYTES // (8 * d))
    cap = max(1, min(cap, m))
    rows = -(-m // cap)
    return LaunchPlan(cluster=k, window=window, threads=threads, pairs=pairs, stages=stages,
                      slot_floats=slot, smem_bytes=smem, clusters=-(-m // rows),
                      rows_per_cluster=rows)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels; declare the C signatures."""
    lib = _build.load_library("dp_aggregate", _SOURCES)
    p, i64, f32, u32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint32,
                             ctypes.c_int)
    lib.dp_aggregate_launch.argtypes = [
        p, p, i32, i64, i64, f32, p, f32, u32, i64, p, p,
        i32, i32, i32, i32, i32, i32, i32, i32, i64, p, p, p, p, p, p]
    lib.dp_aggregate_launch.restype = i32
    lib.dp_aggregate_max_clusters.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.dp_aggregate_max_clusters.restype = i32
    lib.dp_aggregate_attributes.argtypes = [i32, i32, i32] + [ctypes.POINTER(i32)] * 3
    lib.dp_aggregate_attributes.restype = i32
    lib.dp_aggregate_error_name.argtypes = [i32]
    lib.dp_aggregate_error_name.restype = ctypes.c_char_p
    lib.ldp_noise_launch.argtypes = [p, i64, i64, f32, u32, i64, p, p, p, p]
    lib.ldp_noise_launch.restype = i32
    return lib


@functools.cache
def _max_clusters(device_index: int, mode: int, pairs: int, cluster: int, threads: int,
                  smem_bytes: int) -> int:
    """cudaOccupancyMaxActiveClusters for one kernel and shape, on one card."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = load_library().dp_aggregate_max_clusters(mode, pairs, cluster, threads,
                                                       smem_bytes, ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"dp_aggregate: no cluster of {cluster} x {threads} threads with "
                           f"{smem_bytes} B of shared memory fits (CUDA error {err})")
    return out.value


def launch_plan(m: int, d: int, mode: str, device) -> LaunchPlan:
    """The plan ``dp_aggregate_sums`` launches on a CUDA ``device`` for (m, d) in ``mode``."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _card_plan(m, d, mode, index)


def max_active_clusters(m: int, d: int, mode: str, device) -> int:
    """How many clusters of (m, d)'s launch shape the card holds at once
    (cudaOccupancyMaxActiveClusters); the plan takes at most that many."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    shape = _launch_plan(m, d)
    return _max_clusters(index, _MODES[mode], shape.pairs, shape.cluster, shape.threads,
                         shape.smem_bytes)


@functools.lru_cache(maxsize=256)
def _card_plan(m: int, d: int, mode: str, index: int) -> LaunchPlan:
    return _launch_plan(m, d, sms=torch.cuda.get_device_properties(index).multi_processor_count,
                        max_clusters=max_active_clusters(m, d, mode, index))


def kernel_attributes(mode: str | None, pairs: int = 0, gated: bool = False) -> dict[str, int]:
    """Registers, spill (local) bytes and static shared memory of the
    aggregation kernel for (mode, pairs), its gated instance with ``gated``,
    or of the noise-only kernel (mode None)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = load_library().dp_aggregate_attributes(-1 if mode is None else _MODES[mode], pairs,
                                                 int(gated), *map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f"dp_aggregate attributes ({mode}, {pairs}): CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "static_smem"), (v.value for v in vals)))


# per (device, stream): the kernel's 16 ticket counters, zero between launches
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _tickets_for(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(16, dtype=torch.int32, device=device)
    return _tickets[key]


def _check(name: str, x: torch.Tensor, shape=None) -> torch.Tensor:
    if x.dim() != 2 and shape is None:
        raise ValueError(f"{name} must be (M, d), got shape {tuple(x.shape)}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{name} must be a float tensor, got {x.dtype}")
    return x.to(torch.float32).contiguous()


def _clip_arg(clip_norm, device: torch.device) -> tuple[float, int | None]:
    """(C as a float, or the address of a 0-d float32 tensor on ``device`` holding C)."""
    if not isinstance(clip_norm, torch.Tensor):
        return float(clip_norm), None
    if clip_norm.dim() != 0 or clip_norm.dtype != torch.float32:
        raise ValueError(f"a tensor clip_norm must be 0-d float32, got shape "
                         f"{tuple(clip_norm.shape)} {clip_norm.dtype}")
    if clip_norm.device != device:
        raise ValueError(f"clip_norm lies on {clip_norm.device}, the updates on {device}")
    return 0.0, clip_norm.data_ptr()


def _row_arg(name: str, x: torch.Tensor | None, m: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor | None:
    """A per-row operand as the kernel reads it: (m,) of ``dtype``, contiguous,
    on ``device`` (a cast or copy stays on the device: nothing is read back)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor) or x.dim() != 1 or x.shape[0] != m:
        raise ValueError(f"{name} must be a ({m},) tensor, got "
                         f"{tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)}")
    if x.device.type != device.type or (device.index is not None
                                        and x.device.index != device.index):
        raise ValueError(f"{name} lies on {x.device}, the rows on {device}")
    return x.to(dtype).contiguous()


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _seed32(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"noise seed must be a 32-bit unsigned int, got {seed}")
    return seed


def _on_device(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device.type != device.type or (device.index is not None
                                        and x.device.index != device.index):
        raise ValueError(f"{name} lies on {x.device}, the rows on {device}")


def _seed_arg(seed, device: torch.device) -> tuple[int, int | None]:
    """(the seed as an int, or the address of a 0-d int64 tensor on ``device``
    holding it in [0, 2**32)): the kernel reads its low 32-bit word there, so
    a launch captured in a CUDA graph reads each replay's seed."""
    if not isinstance(seed, torch.Tensor):
        return _seed32(seed or 0), None
    if seed.dim() != 0 or seed.dtype != torch.int64:
        raise ValueError(f"a tensor noise seed must be 0-d int64, got shape "
                         f"{tuple(seed.shape)} {seed.dtype}")
    _on_device("noise_seed", seed, device)
    return 0, seed.data_ptr()


def _sigma_arg(sigma, device: torch.device) -> tuple[float, int | None]:
    """(sigma as a float, or the address of a 0-d float32 tensor on ``device``
    holding it), as ``_seed_arg``."""
    if not isinstance(sigma, torch.Tensor):
        return float(sigma or 0.0), None
    if sigma.dim() != 0 or sigma.dtype != torch.float32:
        raise ValueError(f"a tensor noise sigma must be 0-d float32, got shape "
                         f"{tuple(sigma.shape)} {sigma.dtype}")
    _on_device("noise_sigma", sigma, device)
    return 0.0, sigma.data_ptr()


def _host_scalar(x):
    """A CPU tensor's value (the plain versions take Python numbers)."""
    return x.item() if isinstance(x, torch.Tensor) else x


def dp_aggregate_sums(updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                      *, noise_seed: int | None = None, noise_sigma=None,
                      row_start: int = 0, row_gate: torch.Tensor | None = None,
                      row_ids: torch.Tensor | None = None):
    """Clip rows to L2 <= C, add noise, reduce: raw SUMS, not means.

    Returns ``(sum_released (d,), sum_sq_released (), sum_sq_clipped ())``,
    float32 on the input's device.  Noise modes: none (neither ``noise`` nor
    ``noise_seed``), operand (a materialized (M, d) ``noise``), fused
    (``noise_seed`` and ``noise_sigma``: the kernel draws sigma * N(0, 1)).
    ``clip_norm`` is a Python float or a 0-d float32 tensor on the updates'
    device, which the kernel reads there (no host read of it); so are
    ``noise_sigma`` and ``noise_seed`` (a 0-d int64 tensor in [0, 2**32)), so
    that a launch captured in a CUDA graph reads each replay's values.
    ``row_gate`` ((M,) on the updates' device): a row enters the sums only
    where its gate is > 0, once, whatever the gate's size; a row gated off
    adds nothing, NaN or not, and draws no noise.  ``row_ids`` ((M,) integer
    client indices on that device): row i's fused noise is client
    ``row_ids[i]``'s, in place of ``row_start + i``.
    """
    if noise is not None and noise_seed is not None:
        raise ValueError("materialized noise and in-kernel noise are exclusive")
    if noise_seed is not None and noise_sigma is None:
        raise ValueError("`noise_seed` requires `noise_sigma` (sigma=0 would "
                         "silently release un-noised updates)")
    u = _check("updates", updates)
    m, d = u.shape
    if m < 1 or d < 1:
        raise ValueError(f"updates must be non-empty, got shape {(m, d)}")
    if noise is not None:
        noise = _check("noise", noise, (m, d))
    clip, clip_at = _clip_arg(clip_norm, u.device)
    row_gate = _row_arg("row_gate", row_gate, m, torch.float32, u.device)
    row_ids = _row_arg("row_ids", row_ids, m, torch.int32, u.device)
    if u.device.type == "cpu":
        if noise_seed is not None:
            noise = ref.ldp_noise_ref(m, d, _seed32(_host_scalar(noise_seed)),
                                      _host_scalar(noise_sigma), row_start=row_start,
                                      row_ids=row_ids)
        return ref.dp_aggregate_ref(u, noise, clip_norm, row_gate=row_gate)
    if u.device.type != "cuda":
        raise ValueError(f"dp_aggregate runs on cpu or cuda tensors, got {u.device}")
    if noise is not None and noise.device != u.device:
        raise ValueError("noise must lie on the updates' device")
    mode = "operand" if noise is not None else ("fused" if noise_seed is not None else "none")
    lib = load_library()
    plan = launch_plan(m, d, mode, u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=u.device)
    seed, seed_at = _seed_arg(noise_seed, u.device)
    sigma, sigma_at = _sigma_arg(noise_sigma, u.device)
    scratch = torch.empty(plan.clusters * (d + plan.cluster + 1), **f32)
    out = torch.empty(d + 2, **f32)
    err = lib.dp_aggregate_launch(
        u.data_ptr(), None if noise is None else noise.data_ptr(), _MODES[mode],
        m, d, clip, clip_at, sigma, seed, int(row_start), _ptr(row_gate), _ptr(row_ids),
        plan.cluster, plan.window, plan.threads, plan.pairs, plan.stages, plan.slot_floats,
        plan.smem_bytes, plan.clusters, plan.rows_per_cluster,
        scratch.data_ptr(), _tickets_for(u.device, stream).data_ptr(), out.data_ptr(), stream,
        seed_at, sigma_at)
    if err != 0:
        raise RuntimeError(f"dp_aggregate kernel launch failed for {plan}: "
                           f"{lib.dp_aggregate_error_name(err).decode()} ({err})")
    dp_aggregate_sums.launches += 1
    dp_aggregate_sums.gated_launches += int(row_gate is not None)
    return out[:d], out[d], out[d + 1]


dp_aggregate_sums.launches = 0
dp_aggregate_sums.gated_launches = 0


def dp_aggregate_sums_chunked(updates: torch.Tensor, clip_norm,
                              noise: torch.Tensor | None = None, *, chunk_m: int,
                              slots: torch.Tensor | None = None,
                              slot_mask: torch.Tensor | None = None,
                              row_gate: torch.Tensor | None = None, noise_seed: int | None = None,
                              noise_sigma=None, compress_fn=None):
    """``dp_aggregate_sums`` over row chunks of ``chunk_m``: one launch a
    chunk of ``ref.chunk_grid`` (the last padded, its padding gated off),
    the sums added on the device.

    A launch's rows are bounded by ``chunk_m``, whatever the cohort.  With
    ``slots`` and ``slot_mask`` (a gathered cohort's slot table, on the
    updates' device) each chunk gathers its slots' rows right before its
    launch, and the launch is the gated instance: ``slot_mask`` is its row
    gate and the slots its noise keys (``row_ids``), so a fused-noise chunk
    draws its clients' rows of the cohort's noise.  Without slots, chunk j's
    rows are keyed from ``j chunk_m`` and gated by their rows of
    ``row_gate``, if given.  The sums are the one-launch sums re-associated
    at chunk boundaries; ``ref.dp_aggregate_sums_chunked_ref`` is the plain
    version (``ref.chunked_sums`` is the loop of both).

    ``compress_fn`` (a linear per-row map (c, d) -> (c, kc), a compressed
    aggregation layer's): each chunk's gated rows are compressed and scaled
    by their clip scales in plain PyTorch, no launch, and the (kc,) sums
    add; the scalar sums are the dense clipped ones, released = clipped.
    Per-row noise with it raises: LDP noise is a full R^d vector a client.
    """
    if compress_fn is not None:
        if noise is not None or noise_seed is not None:
            raise ValueError(
                "compress_fn cannot combine with per-row noise: LDP noise is a full R^d "
                "vector per client, drawn before aggregation; compressing it afterwards "
                "breaks the privacy accounting")
        return ref.chunked_sums(functools.partial(ref.compressed_sums, compress_fn=compress_fn),
                                updates, clip_norm, chunk_m=chunk_m, slots=slots,
                                slot_mask=slot_mask, row_gate=row_gate)
    return ref.chunked_sums(dp_aggregate_sums, updates, clip_norm, noise, chunk_m=chunk_m,
                            slots=slots, slot_mask=slot_mask, row_gate=row_gate,
                            noise_seed=noise_seed, noise_sigma=noise_sigma)


def dp_aggregate(updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                 *, noise_seed: int | None = None, noise_sigma=None,
                 row_start: int = 0) -> RoundStats:
    """Fused clip(+noise)+aggregate returning the FedEXP round statistics."""
    sums = dp_aggregate_sums(updates, clip_norm, noise, noise_seed=noise_seed,
                             noise_sigma=noise_sigma, row_start=row_start)
    return RoundMoments(*sums, count=updates.shape[0]).stats()


def generate_ldp_noise(m: int, d: int, noise_seed: int, noise_sigma, *, device,
                       row_start: int = 0, row_ids: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The (m, d) noise the fused mode draws for ``noise_seed`` (its test
    oracle): row i is client ``row_start + i``'s, or ``row_ids[i]``'s.  The
    seed and sigma may be 0-d tensors on ``device``, as ``dp_aggregate_sums``
    takes them (a tensor sigma is not checked for finiteness: that would read
    the device)."""
    device = torch.device(device)
    if device.type == "cpu":
        noise_seed, noise_sigma = _host_scalar(noise_seed), _host_scalar(noise_sigma)
    if m < 1 or d < 1 or (not isinstance(noise_sigma, torch.Tensor)
                          and not math.isfinite(float(noise_sigma))):
        raise ValueError(f"bad noise request m={m} d={d} sigma={noise_sigma}")
    row_ids = _row_arg("row_ids", row_ids, m, torch.int32, device)
    if device.type == "cpu":
        return ref.ldp_noise_ref(m, d, _seed32(noise_seed), noise_sigma, row_start=row_start,
                                 row_ids=row_ids)
    if device.type != "cuda":
        raise ValueError(f"generate_ldp_noise runs on cpu or cuda, got {device}")
    seed, seed_at = _seed_arg(noise_seed, device)
    sigma, sigma_at = _sigma_arg(noise_sigma, device)
    out = torch.empty(m, d, dtype=torch.float32, device=device)
    err = load_library().ldp_noise_launch(
        out.data_ptr(), m, d, sigma, seed, int(row_start), _ptr(row_ids),
        torch.cuda.current_stream(device).cuda_stream, seed_at, sigma_at)
    if err != 0:
        raise RuntimeError(f"ldp_noise kernel launch failed: CUDA error {err}")
    generate_ldp_noise.launches += 1
    return out


generate_ldp_noise.launches = 0
