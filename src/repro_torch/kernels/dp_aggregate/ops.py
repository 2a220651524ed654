"""Wrappers of the dp_aggregate kernels (counterpart of repro/kernels/dp_aggregate/ops.py).

A wrapper decides by the tensor's device alone: a CPU tensor runs the plain
version in ``ref.py``; a CUDA tensor launches the hand-written kernel
(``csrc/dp_aggregate.cu``) or raises.  Each wrapper counts its kernel
launches in a plain integer attribute (``dp_aggregate_sums.launches``,
``generate_ldp_noise.launches``), which ``chip_smoke.py`` zeroes before it
drives the main path and reads after.

Unlike the JAX wrapper, nothing is padded: the kernel masks ragged M and d
itself.  Noise is keyed by (seed, global row, column), so ``row_start`` gives
a slice of the cohort the rows of the whole cohort's noise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.core.aggregation import RoundMoments, RoundStats
from repro_torch.kernels import _build
from repro_torch.kernels.dp_aggregate import ref

__all__ = ["dp_aggregate", "dp_aggregate_sums", "generate_ldp_noise", "load_library"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "dp_aggregate.cu",)

_THREADS = 256              # columns per block of the column kernel
_TARGET_BLOCKS = 8 * 132    # ~8 resident 256-thread blocks on each of the 132 SMs
_MAX_GRID_Y = 65535
_MODES = {"none": 0, "operand": 1, "fused": 2}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels; declare the C signatures."""
    lib = _build.load_library("dp_aggregate", _SOURCES)
    p, i64, f32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint32
    lib.dp_aggregate_launch.argtypes = [
        p, p, ctypes.c_int, i64, i64, f32, f32, u32, i64, i64, ctypes.c_int,
        p, p, p, p, p, p, p, p]
    lib.dp_aggregate_launch.restype = ctypes.c_int
    lib.ldp_noise_launch.argtypes = [p, i64, i64, f32, u32, i64, p]
    lib.ldp_noise_launch.restype = ctypes.c_int
    return lib


def _launch_plan(m: int, d: int) -> tuple[int, int]:
    """(rows_per_split, splits) of the column kernel: enough row splits that
    the (ceil(d/256), splits) grid fills the card, each split a contiguous
    row range."""
    col_blocks = -(-d // _THREADS)
    splits = min(m, _MAX_GRID_Y, max(1, -(-_TARGET_BLOCKS // col_blocks)))
    rows_per_split = -(-m // splits)
    return rows_per_split, -(-m // rows_per_split)


def _check(name: str, x: torch.Tensor, shape=None) -> torch.Tensor:
    if x.dim() != 2 and shape is None:
        raise ValueError(f"{name} must be (M, d), got shape {tuple(x.shape)}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{name} must be a float tensor, got {x.dtype}")
    return x.to(torch.float32).contiguous()


def _seed32(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**32:
        raise ValueError(f"noise seed must be a 32-bit unsigned int, got {seed}")
    return seed


def dp_aggregate_sums(updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                      *, noise_seed: int | None = None, noise_sigma=None,
                      row_start: int = 0):
    """Clip rows to L2 <= C, add noise, reduce: raw SUMS, not means.

    Returns ``(sum_released (d,), sum_sq_released (), sum_sq_clipped ())``,
    float32 on the input's device.  Noise modes: none (neither ``noise`` nor
    ``noise_seed``), operand (a materialized (M, d) ``noise``), fused
    (``noise_seed`` and ``noise_sigma``: the kernel draws sigma * N(0, 1)).
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
    if u.device.type == "cpu":
        if noise_seed is not None:
            noise = ref.ldp_noise_ref(m, d, _seed32(noise_seed), noise_sigma,
                                      row_start=row_start)
        return ref.dp_aggregate_ref(u, noise, clip_norm)
    if u.device.type != "cuda":
        raise ValueError(f"dp_aggregate runs on cpu or cuda tensors, got {u.device}")
    if noise is not None and noise.device != u.device:
        raise ValueError("noise must lie on the updates' device")
    mode = "operand" if noise is not None else ("fused" if noise_seed is not None else "none")
    lib = load_library()
    rows_per_split, splits = _launch_plan(m, d)
    col_blocks = -(-d // _THREADS)
    f32 = dict(dtype=torch.float32, device=u.device)
    row_sq, scale = torch.empty(m, **f32), torch.empty(m, **f32)
    col_partial = torch.empty(splits, d, **f32)
    sq_partial = torch.empty(splits * col_blocks, **f32)
    out_sum = torch.empty(d, **f32)
    out_sq_rel, out_sq_clip = torch.empty((), **f32), torch.empty((), **f32)
    err = lib.dp_aggregate_launch(
        u.data_ptr(), None if noise is None else noise.data_ptr(), _MODES[mode],
        m, d, float(clip_norm), float(noise_sigma or 0.0),
        _seed32(noise_seed or 0), int(row_start), rows_per_split, splits,
        row_sq.data_ptr(), scale.data_ptr(), col_partial.data_ptr(),
        sq_partial.data_ptr(), out_sum.data_ptr(), out_sq_rel.data_ptr(),
        out_sq_clip.data_ptr(), torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dp_aggregate kernel launch failed: CUDA error {err}")
    dp_aggregate_sums.launches += 1
    return out_sum, out_sq_rel, out_sq_clip


dp_aggregate_sums.launches = 0


def dp_aggregate(updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                 *, noise_seed: int | None = None, noise_sigma=None,
                 row_start: int = 0) -> RoundStats:
    """Fused clip(+noise)+aggregate returning the FedEXP round statistics."""
    sums = dp_aggregate_sums(updates, clip_norm, noise, noise_seed=noise_seed,
                             noise_sigma=noise_sigma, row_start=row_start)
    return RoundMoments(*sums, count=updates.shape[0]).stats()


def generate_ldp_noise(m: int, d: int, noise_seed: int, noise_sigma, *, device,
                       row_start: int = 0) -> torch.Tensor:
    """The (m, d) noise the fused mode draws for ``noise_seed`` (its test oracle)."""
    device = torch.device(device)
    if m < 1 or d < 1 or not math.isfinite(float(noise_sigma)):
        raise ValueError(f"bad noise request m={m} d={d} sigma={noise_sigma}")
    if device.type == "cpu":
        return ref.ldp_noise_ref(m, d, _seed32(noise_seed), noise_sigma, row_start=row_start)
    if device.type != "cuda":
        raise ValueError(f"generate_ldp_noise runs on cpu or cuda, got {device}")
    out = torch.empty(m, d, dtype=torch.float32, device=device)
    err = load_library().ldp_noise_launch(
        out.data_ptr(), m, d, float(noise_sigma), _seed32(noise_seed), int(row_start),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ldp_noise kernel launch failed: CUDA error {err}")
    generate_ldp_noise.launches += 1
    return out


generate_ldp_noise.launches = 0
