"""Plain PyTorch version of the dp_aggregate kernels.

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  The noise
generator is the kernels' own, written out with int64 tensors masked to 32
bits: Threefry-2x32-20 keyed by (seed, 0x9E3779B9) over the counter
(global row, column pair), then Box-Muller, whose two outputs are columns
2k and 2k+1.  It gives the kernels' noise up to the rounding of log, cos,
sin and sqrt.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "ldp_noise_ref", "dp_aggregate_ref", "clip_scale", "chunk_grid",
           "grid_rows", "chunked_sums", "plain_sums", "dp_aggregate_sums_chunked_ref"]

_EPS = 1e-12
_MASK = 0xFFFFFFFF
_THREEFRY_C = 0x1BD11BDA
_GOLDEN = 0x9E3779B9
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TWO_PI = float(np.float32(2.0 * np.pi))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """20-round Threefry-2x32 on int64 tensors holding uint32 values."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _THREEFRY_C) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for j in range(1, 6):
        for r in _ROT[(j - 1) % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[j % 3]) & _MASK
        x1 = (x1 + ks[(j + 1) % 3] + j) & _MASK
    return x0, x1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in the open interval (0, 1) (top 24 bits)."""
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def ldp_noise_ref(m: int, d: int, seed: int, sigma: float, *, row_start: int = 0,
                  row_ids: torch.Tensor | None = None, device="cpu") -> torch.Tensor:
    """(m, d) float32 noise: sigma * N(0, 1), two normals per Threefry call.

    Row ``r = row_start + i`` (or ``r = row_ids[i]``, a gathered block's
    client indices, on ``device``) and column pair ``k`` take
    ``(b0, b1) = threefry2x32((seed, 0x9E3779B9), (r, k))``; then
    ``rho = sqrt(-2 log unit(b0))``, ``theta = 2 pi unit(b1)`` and
    ``z[r, 2k] = rho cos theta``, ``z[r, 2k + 1] = rho sin theta``.  An odd d
    drops the last pair's sine, so the first d' columns of any wider draw are
    this draw.
    """
    pairs = (d + 1) // 2
    if row_ids is None:
        rows = torch.arange(row_start, row_start + m, dtype=torch.int64, device=device)
    else:
        rows = row_ids.to(device=device, dtype=torch.int64) & _MASK
    ks = torch.arange(pairs, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(int(seed), _GOLDEN, rows[:, None].expand(m, pairs),
                          ks[None, :].expand(m, pairs))
    rho = torch.sqrt(-2.0 * torch.log(_bits_to_unit(b0)))
    theta = _TWO_PI * _bits_to_unit(b1)
    z = torch.stack((rho * torch.cos(theta), rho * torch.sin(theta)), dim=-1)
    return float(sigma) * z.reshape(m, 2 * pairs)[:, :d]


def clip_scale(sq_norms: torch.Tensor, clip_norm) -> torch.Tensor:
    """Per-row scale min(1, C / sqrt(max(||u||^2, eps))), as the kernel computes it.

    C is a float or a 0-d float32 tensor on the rows' device; either way the
    quotient is a float32 division, as in the kernel (a float divided by a
    tensor would be a reciprocal and a product)."""
    if not isinstance(clip_norm, torch.Tensor):
        clip_norm = torch.full_like(sq_norms, clip_norm)
    return torch.clamp(clip_norm / torch.sqrt(torch.clamp(sq_norms, min=_EPS)), max=1.0)


def dp_aggregate_ref(updates: torch.Tensor, noise: torch.Tensor | None, clip_norm,
                     row_gate: torch.Tensor | None = None):
    """(sum_released (d,), sum_sq_released (), sum_sq_clipped ()) in float32.

    With ``row_gate``, the rows whose gate is not > 0 are zeroed, and their
    noise too, with ``where`` before anything else (a NaN there cannot
    leak): they add nothing to any sum."""
    u = updates.to(torch.float32)
    if row_gate is not None:
        keep = (row_gate > 0)[:, None]
        u = torch.where(keep, u, 0.0)
        if noise is not None:
            noise = torch.where(keep, noise.to(torch.float32), 0.0)
    sq_norms = torch.sum(u * u, dim=-1)
    scale = clip_scale(sq_norms, clip_norm)
    clipped = u * scale[:, None]
    sq_clipped = torch.sum(sq_norms * (scale * scale))
    if noise is None:
        return clipped.sum(dim=0), sq_clipped, sq_clipped
    released = clipped + noise.to(torch.float32)
    return released.sum(dim=0), torch.sum(released * released), sq_clipped


def chunk_grid(rows: int, chunk: int):
    """The chunk grid of ``rows`` rows: ``(j0, idx, valid)`` for each chunk
    of ``chunk`` rows, in order.

    This is the one definition of the streaming engine's grid, which its
    round (``fedsim.server.chunk_plan``), ``fedsim.local.chunk_cohort``,
    ``core.aggregation.streamed_clip_moments`` and ``chunked_sums`` walk.
    The rows are padded to a multiple of ``chunk``, and chunk j is rows
    ``[j0, j0 + chunk)`` with ``j0 = j chunk``: ``idx`` (chunk,) int64 on the
    host holds them, a row past ``rows`` replaced by row 0 (real data, so
    work on it stays finite), and ``valid`` (chunk,) float32 is 1 below
    ``rows`` and 0 on the padding.  A caller multiplies ``valid`` into the
    chunk's mask or gate, so a padded row adds to no sum and draws no noise;
    every row keeps its padded-grid index ``j0 + i`` as its noise key
    (``row_start = j0``)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for j0 in range(0, rows, chunk):
        g = torch.arange(j0, j0 + chunk)
        yield j0, torch.where(g < rows, g, 0), (g < rows).to(torch.float32)


def grid_rows(x: torch.Tensor, j0: int, idx: torch.Tensor) -> torch.Tensor:
    """Chunk ``(j0, idx)``'s rows of ``x``: a view when they are all below
    ``x``'s rows, else a gather of ``idx`` (the padded last chunk), whose
    indices reach a card from pinned memory without waiting for it."""
    c = idx.shape[0]
    if j0 + c <= x.shape[0]:
        return x[j0:j0 + c]
    if x.device.type == "cuda":
        idx = idx.pin_memory().to(x.device, non_blocking=True)
    return x.index_select(0, idx)


def chunked_sums(reduce, updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                 *, chunk_m: int, slots: torch.Tensor | None = None,
                 slot_mask: torch.Tensor | None = None, row_gate: torch.Tensor | None = None,
                 noise_seed: int | None = None, noise_sigma=None):
    """The three sums of ``reduce`` (``dp_aggregate_sums``'s signature)
    accumulated over the chunks of ``chunk_grid``, one call a chunk of
    ``chunk_m`` rows (at most the rows reduced).

    Without ``slots`` chunk j is rows ``[j c, (j + 1) c)`` of ``updates``,
    gated by those of ``row_gate`` and keyed from ``j c``.  With
    ``slots`` ((cap,) client indices on the updates' device, as
    ``fedsim.local.gather_slots`` packs them) chunk j gathers the rows of
    slots ``[j c, (j + 1) c)`` right before its call, gated by the same rows
    of ``slot_mask`` (a padding slot holds client 0 and mask 0) and keyed by
    the slots; ``noise`` is then slot-aligned, (cap, d).  A padded last
    chunk's padding is gated off.  The sums are the one-call sums
    re-associated at chunk boundaries."""
    if chunk_m < 1:
        raise ValueError(f"chunk_m must be >= 1, got {chunk_m}")
    if slots is not None and slot_mask is None:
        raise ValueError("slots requires slot_mask (padding slots hold index 0; an unmasked "
                         "gather would count client 0's update twice)")
    if slots is not None and row_gate is not None:
        raise ValueError("with slots the gate is slot_mask; row_gate gates ungathered rows")
    rows = updates.shape[0] if slots is None else slots.shape[0]
    if noise is not None and noise.shape[0] != rows:
        raise ValueError(f"noise must have one row per reduced row ({rows}), got "
                         f"{tuple(noise.shape)}")
    gate_all = row_gate if slots is None else slot_mask
    acc = None
    for j0, idx, valid in chunk_grid(rows, min(chunk_m, rows)):
        padded = j0 + idx.shape[0] > rows
        gate = None if gate_all is None else grid_rows(gate_all, j0, idx)
        if padded:
            valid = valid.to(updates.device)
            gate = valid if gate is None else gate * valid
        if slots is None:
            u, keys = grid_rows(updates, j0, idx), {"row_start": j0}
        else:
            ids = grid_rows(slots, j0, idx)
            u, keys = updates.index_select(0, ids), {"row_ids": ids}
        if noise_seed is None:
            keys = {}
        sums = reduce(u, clip_norm, None if noise is None else grid_rows(noise, j0, idx),
                      noise_seed=noise_seed, noise_sigma=noise_sigma, row_gate=gate, **keys)
        acc = sums if acc is None else tuple(a + b for a, b in zip(acc, sums))
    return acc


def plain_sums(updates, clip_norm, noise=None, *, noise_seed=None, noise_sigma=None,
                row_start=0, row_gate=None, row_ids=None):
    """``dp_aggregate_sums`` in plain PyTorch on any device."""
    if noise_seed is not None:
        noise = ldp_noise_ref(*updates.shape, noise_seed, noise_sigma, row_start=row_start,
                              row_ids=row_ids, device=updates.device)
    return dp_aggregate_ref(updates, noise, clip_norm, row_gate=row_gate)


def dp_aggregate_sums_chunked_ref(updates: torch.Tensor, clip_norm,
                                  noise: torch.Tensor | None = None, **kw):
    """The plain version of ``ops.dp_aggregate_sums_chunked``:
    ``dp_aggregate_ref`` a chunk (``chunked_sums``), on any device."""
    return chunked_sums(plain_sums, updates, clip_norm, noise, **kw)
