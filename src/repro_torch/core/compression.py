"""Compressed-communication primitives: rand-k and count-sketch (counterpart
of repro/core/compression.py).

Both compressors are linear maps R^d -> R^kc applied per client row, so
``sum_i compress(c_i) == compress(sum_i c_i)``: compressed partial sums add
across blocks of clients and stream chunks like the dense ones, and a clip
scale commutes with them (``compress(u * s) == compress(u) * s``), so the
moment path compresses the raw rows and scales the (m, kc) block; the
clipped (M, d) matrix never exists.

Each round's plan (the rand-k index set, the sketch's bucket and sign
tables) comes from a generator of its own, ``plan_generator(round seed)``,
keyed by the round's seed and ``COMPRESS_TAG`` as each fault class is keyed
(``fedsim.faults.fault_masks``): a compressed composition consumes the round
generator's other draws unchanged, and every chunk or gathered block of a
round reads the one plan.  The tables are drawn on the device, from a device
generator that the plan generator seeds.

The functions are deterministic on the card, where three plain PyTorch
operations are not, or differ from ``jnp``:

* The sketch's bucket sums are not a scatter-add (CUDA adds by atomics, in
  an order that changes from run to run).  ``sketch_plan`` sorts each
  depth's bucket ids once a round (stably, so a bucket's columns keep their
  order) into a (depth, width, L) table of columns, padded to the fullest
  bucket with the index d of a zero column; ``sketch_compress`` gathers
  each bucket's signed columns through it and sums them in that order.
* ``jnp.median`` averages the two middle values of an even count;
  ``torch.median`` returns the lower one.  ``sketch_decompress`` sorts over
  the depth and averages the middle pair, as ``jnp`` does.
* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk`` on
  the card promises no order.  ``topk_select`` sorts |x| stably.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.algorithm import device_generator

__all__ = [
    "COMPRESS_TAG",
    "SketchPlan",
    "plan_generator",
    "randk_plan",
    "randk_compress",
    "randk_decompress",
    "sketch_plan",
    "bucket_slots",
    "sketch_compress",
    "sketch_decompress",
    "topk_select",
]

# the tag of a round's compression plan: its generator is keyed by the round's
# seed and this tag (``plan_generator``).  The JAX package's value: 2**31 - 1,
# - 2 and - 3 tag sampling, local training and faults there, and no client
# index reaches them.
COMPRESS_TAG = 2**31 - 4


def plan_generator(round_seed: int) -> torch.Generator:
    """The CPU generator of a round's compression plan, keyed by the round's
    seed (``gen.initial_seed()`` of its round generator) and ``COMPRESS_TAG``."""
    state = np.random.SeedSequence([int(round_seed), COMPRESS_TAG]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


# ---------------------------------------------------------------------------
# Rand-k: unbiased random coordinate subsampling
# ---------------------------------------------------------------------------

def randk_plan(gen: torch.Generator, d: int, k: int, device="cpu") -> torch.Tensor:
    """(k,) distinct int64 coordinate indices, each coordinate kept with
    probability k/d, on ``device``.

    When k divides d the draw is stratified: k blocks of d/k coordinates
    and one uniform offset in each, the exact k/d marginal from k draws.
    Otherwise the first k of a permutation of d; ``arange(d)`` when k >= d.
    """
    device = torch.device(device)
    if k >= d:
        return torch.arange(d, device=device)
    g = device_generator(gen, device)
    if d % k == 0:
        stride = d // k
        offs = torch.randint(0, stride, (k,), generator=g, device=device)
        return torch.arange(k, device=device) * stride + offs
    return torch.randperm(d, generator=g, device=device)[:k]


def randk_compress(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plan's coordinates of ``u``'s last axis: (..., d) -> (..., k).  A
    coordinate projection: linear and an L2 contraction."""
    return u.index_select(-1, idx.to(u.device, torch.int64))


def randk_decompress(comp: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """The unbiased (d,) estimate of a (k,) compressed sum: scattered to its
    coordinates and scaled by d/k (a float32 constant, as in the JAX package)."""
    k = idx.shape[0]
    scale = float(np.float32(d / k))
    out = comp.new_zeros(d)
    return out.index_copy_(0, idx.to(comp.device, torch.int64), comp * scale)


# ---------------------------------------------------------------------------
# Count-sketch: bucket and sign hashing, median-of-depth recovery
# ---------------------------------------------------------------------------

class SketchPlan(NamedTuple):
    """A round's sketch tables: ``h`` (depth, d) int64 bucket ids in [0,
    width), ``s`` (depth, d) float32 signs, and ``slots`` (depth, width, L)
    int64, bucket b's columns of depth t in ascending order, padded with d
    (``bucket_slots``).  A plain ``(h, s)`` pair is a plan too; the sketch
    then builds its slots at every call."""

    h: torch.Tensor
    s: torch.Tensor
    slots: torch.Tensor | None = None


def bucket_slots(h: torch.Tensor, width: int) -> torch.Tensor:
    """(depth, width, L) int64: row (t, b) lists the columns j with ``h[t, j]
    == b`` in ascending order, padded with d to L, the fullest bucket's
    size.  Built by a stable sort of each depth's ids; its size is read on
    the host, the one wait for the device of a round's sketch plan."""
    h = h.to(torch.int64)
    depth, d = h.shape
    counts = torch.zeros((depth, width), dtype=torch.int64, device=h.device)
    counts.scatter_add_(1, h, torch.ones_like(h))      # integer sums: exact in any order
    fullest = max(1, int(counts.max()))
    order = torch.sort(h, dim=1, stable=True).indices   # columns in bucket order
    bucket = torch.gather(h, 1, order)
    first = torch.cumsum(counts, dim=1) - counts        # each bucket's first position
    pos = torch.arange(d, device=h.device) - torch.gather(first, 1, bucket)
    slots = torch.full((depth, width * fullest), d, dtype=torch.int64, device=h.device)
    slots.scatter_(1, bucket * fullest + pos, order)    # one column a cell
    return slots.view(depth, width, fullest)


def sketch_plan(gen: torch.Generator, d: int, width: int, depth: int,
                device="cpu") -> SketchPlan:
    """A round's sketch tables on ``device``: (depth, d) uniform bucket ids in
    [0, width), (depth, d) uniform signs, and their ``bucket_slots``."""
    device = torch.device(device)
    g = device_generator(gen, device)
    h = torch.randint(0, width, (depth, d), generator=g, device=device)
    s = torch.randint(0, 2, (depth, d), generator=g, device=device).to(torch.float32) * 2.0 - 1.0
    return SketchPlan(h, s, bucket_slots(h, width))


def _plan_parts(plan, width: int):
    """``(h, s, slots)`` of a ``SketchPlan`` or an ``(h, s)`` pair."""
    h, s = plan[0], plan[1]
    slots = plan[2] if len(plan) > 2 and plan[2] is not None else bucket_slots(h, width)
    return h, s, slots


def sketch_compress(u: torch.Tensor, plan, width: int) -> torch.Tensor:
    """Count-sketch rows of ``u``: (..., d) -> (..., depth * width), depth
    tables side by side, ``S[t, b] = sum over j with h[t, j] = b of s[t, j]
    u[j]``.

    Linear in ``u``.  Each bucket's signed columns are gathered through the
    plan's slots (the padding reads an appended zero column) and summed in
    the slots' order, so a result depends on its inputs alone; one (m, d)
    signed copy and one (m, width, L) gather are live per depth."""
    h, s, slots = _plan_parts(plan, width)
    depth, d = h.shape
    squeeze = u.dim() == 1
    rows = (u[None] if squeeze else u).to(torch.float32)
    m = rows.shape[0]
    s = s.to(rows.device, torch.float32)
    slots = slots.to(rows.device)
    tables = []
    for t in range(depth):
        signed = rows.new_empty((m, d + 1))
        torch.mul(rows, s[t], out=signed[:, :d])
        signed[:, d] = 0.0
        cells = signed.index_select(1, slots[t].reshape(-1))
        tables.append(cells.view(m, width, -1).sum(dim=-1))
    comp = torch.cat(tables, dim=-1)
    return comp[0] if squeeze else comp


def sketch_decompress(comp: torch.Tensor, plan, d: int) -> torch.Tensor:
    """Median-of-depth unsketch: (depth * width,) -> (d,), the median over t
    of ``s[t, j] * S[t, h[t, j]]``; for an even depth the mean of the two
    middle values, and NaN where any value is NaN, as ``jnp.median``."""
    h, s = plan[0].to(comp.device, torch.int64), plan[1].to(comp.device, torch.float32)
    depth = h.shape[0]
    tables = comp.reshape(depth, -1)
    est = s * torch.gather(tables, 1, h)
    ranked = torch.sort(est, dim=0).values
    mid = (ranked[(depth - 1) // 2] + ranked[depth // 2]) * 0.5
    return torch.where(torch.isnan(est).any(dim=0), math.nan, mid)


def topk_select(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly the k largest-|x| coordinates of a (d,) vector, the rest zero;
    among equal |x| the lower index is kept first, as ``jax.lax.top_k``."""
    if k >= x.shape[-1]:
        return x
    idx = torch.sort(torch.abs(x), descending=True, stable=True).indices[:k]
    return torch.zeros_like(x).index_copy_(0, idx, x.index_select(0, idx))
