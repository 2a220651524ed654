"""Server-side aggregation of client updates + the FedEXP round statistics.

Counterpart of repro/core/aggregation.py.  The server needs three reductions
per round (Algorithms 1 & 2):

    cbar      = (1/M) sum_i c_i                  -- the pseudo-gradient
    mean_sq   = (1/M) sum_i ||c_i||^2            -- FedEXP numerator statistic
    agg_sq    = ||cbar||^2                       -- FedEXP denominator

``aggregate_stats`` is the plain reference; ``fused_clip_aggregate`` clips,
optionally adds per-client noise and reduces, through one of three backends:

    "kernel"        the CUDA ``dp_aggregate`` kernel, fed a materialized
                    (M, d) noise matrix when noise is asked for (drawn by the
                    noise-only kernel from ``noise_seed``).
    "kernel-fused"  the same kernel drawing the noise inside it from
                    ``noise_seed``: no (M, d) noise matrix exists.
    "torch"         the plain PyTorch version, on whatever device the
                    tensors lie.
    "auto"          kernel-fused (noise requested) or kernel for a CUDA
                    tensor; torch for a CPU tensor.

The kernel wrappers themselves run their plain version on a CPU tensor, so
every backend computes the same function, with the same noise for a seed.

Moments (the masked-moment protocol of a sampled round).  The three
reductions are sums over clients, so ``partial_clip_moments`` returns them as
SUMS (``RoundMoments``) over the rows a ``weight_mask`` gates in, with
optional per-row ``row_weights``; ``raw_moments`` is the unclipped version
for the noiseless names.  A block of rows names its clients by ``start``:
the global index of row 0, or a (m,) host tensor of global indices (a
gathered cohort, ``global_client_indices``).  On the card the unweighted
masked release is one launch of the kernel, whose ``row_gate`` does what
JAX's ``where`` does outside its kernel and whose ``row_ids`` key a gathered
block's noise by client.  Moments of disjoint blocks add
(``add_moments``): ``streamed_clip_moments`` reduces an (M, d) matrix a
chunk of rows at a time, as the streaming engine reduces its chunks.

Compression (``compress_fn``, ``core.compression``): a linear per-row map
(..., d) -> (..., kc) applied to the released rows, so ``sum_c`` is the (kc,)
compressed sum while the scalar sums stay the dense clipped values.  The
raw rows are compressed once and scaled by their clip scales (the clipped
(M, d) matrix is never built), ``compress_row_bound`` re-clips each
compressed row, and the sums are plain PyTorch on every device: the
kernel's sums are dense, as the JAX package bypasses its kernel under
compression.  Per-row noise with ``compress_fn`` raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "RoundStats",
    "RoundMoments",
    "add_moments",
    "aggregate_stats",
    "fused_clip_aggregate",
    "global_client_indices",
    "partial_clip_moments",
    "raw_moments",
    "resolve_backend",
    "row_keys",
    "streamed_clip_moments",
]

_BACKENDS = ("kernel", "kernel-fused", "torch")
_COMPRESS_NOISE = (
    "compress_fn cannot combine with per-row (LDP) noise: each client's release is a full "
    "R^d vector, so there is nothing sound to compress.  Use central noise (added to the "
    "compressed aggregate) or drop the compression layer.")


@dataclasses.dataclass
class RoundStats:
    """Aggregate statistics of one federated round (all 0-dim tensors but cbar)."""

    cbar: torch.Tensor           # (d,) mean of released updates
    mean_sq: torch.Tensor        # mean_i ||c_i||^2
    agg_sq: torch.Tensor         # ||cbar||^2
    mean_sq_clipped: torch.Tensor | None = None  # mean_i ||clip(Delta_i)||^2 (pre-noise)


@dataclasses.dataclass
class RoundMoments:
    """Partial SUMS of one round's release; moments of disjoint client sets add."""

    sum_c: torch.Tensor           # (d,) sum of released updates
    sum_sq: torch.Tensor          # sum_i ||c_i||^2 (post-noise)
    sum_sq_clipped: torch.Tensor  # sum_i ||clip(Delta_i)||^2 (pre-noise)
    count: torch.Tensor | float   # number of clients (sum of row weights)

    def stats(self) -> RoundStats:
        """Normalize global sums into the RoundStats the step-size rules eat."""
        cbar = self.sum_c / self.count
        return RoundStats(cbar=cbar, mean_sq=self.sum_sq / self.count,
                          agg_sq=torch.sum(cbar * cbar),
                          mean_sq_clipped=self.sum_sq_clipped / self.count)


def add_moments(a, b):
    """The sum of two blocks' moments: ``RoundMoments``, dicts, tuples and
    lists of them, tensors and floats, added leaf by leaf (every field of a
    round's moments is a sum over its clients)."""
    if isinstance(a, RoundMoments):
        return RoundMoments(*(add_moments(getattr(a, f.name), getattr(b, f.name))
                              for f in dataclasses.fields(RoundMoments)))
    if isinstance(a, dict):
        return {k: add_moments(a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(add_moments(x, y) for x, y in zip(a, b))
    return a + b


def global_client_indices(start, m: int, device) -> torch.Tensor:
    """(m,) global client indices (int64, on ``device``) of a block of m rows.

    ``start`` is the global index of row 0 (a contiguous block: ``start +
    arange(m)``) or already a (m,) tensor of global indices (a gathered
    block, where row j holds client ``start[j]``), which passes through,
    copied to ``device`` when it lies elsewhere.
    """
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        from repro_torch.core.algorithm import host_to_device
        return host_to_device(start, device)
    return torch.arange(int(start), int(start) + m, device=device)


def row_keys(start, device) -> dict:
    """The noise keys of a block of clients at ``start``, as the kernel
    wrappers take them: ``row_start`` for a contiguous block, or ``row_ids``,
    a gathered block's client indices as int32 on ``device``."""
    if not isinstance(start, torch.Tensor):
        return {"row_start": int(start), "row_ids": None}
    from repro_torch.core.algorithm import host_to_device
    return {"row_start": 0, "row_ids": host_to_device(start.to(torch.int32), device)}


def aggregate_stats(updates: torch.Tensor) -> RoundStats:
    """Reference reductions over an ``(M, d)`` matrix of released updates."""
    m = updates.shape[0]
    cbar = updates.sum(dim=0) / m
    mean_sq = torch.sum(updates * updates) / m
    return RoundStats(cbar=cbar, mean_sq=mean_sq, agg_sq=torch.sum(cbar * cbar))


def resolve_backend(backend: str | None, device, *, wants_noise_gen: bool = False) -> str:
    """Map "auto"/None to a concrete backend for a tensor on ``device``."""
    if backend in (None, "auto"):
        if torch.device(device).type == "cuda":
            return "kernel-fused" if wants_noise_gen else "kernel"
        return "torch"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         f"use 'auto' or one of {_BACKENDS}")
    return backend


def fused_clip_aggregate(
    raw_updates: torch.Tensor,
    clip_norm,
    noise: torch.Tensor | None = None,
    *,
    noise_seed: int | None = None,
    noise_sigma=None,
    backend: str = "auto",
    row_start: int = 0,
    compress_fn=None,
    compress_row_bound=None,
) -> RoundStats:
    """Clip rows to L2 <= C, optionally add per-client noise, and reduce.

    Args:
      raw_updates: (M, d) raw client updates.
      clip_norm: clipping threshold C (``inf`` releases the rows unclipped): a
        float, or a 0-d float32 tensor on the updates' device that the kernel
        reads there (an adaptive threshold that changes every round).
      noise: optional pre-materialized (M, d) noise matrix (LDP Gaussian);
        None for CDP (noise is added to the mean by the caller, which needs
        ``mean_sq_clipped``).
      noise_seed: 32-bit seed of the per-client Gaussian noise of std
        ``noise_sigma``, keyed by (seed, global row, column).  Mutually
        exclusive with ``noise``.
      noise_sigma: noise std, with ``noise_seed``.
      backend: "auto" | "kernel" | "kernel-fused" | "torch" (module doc).
      row_start: global client index of row 0 (the noise's row key).
      compress_fn / compress_row_bound: a linear per-row compressor and the
        bound its rows are re-clipped to (module doc): ``cbar`` is then the
        (kc,) compressed mean, the scalar statistics the dense ones, reduced
        by ``partial_clip_moments`` in plain PyTorch.

    Returns RoundStats where ``mean_sq`` is computed on the released c_i and
    ``mean_sq_clipped`` on the clipped deltas (pre-noise).
    """
    if compress_fn is not None:
        if noise_seed is not None:
            raise ValueError(_COMPRESS_NOISE)
        return partial_clip_moments(raw_updates, clip_norm, noise, compress_fn=compress_fn,
                                    compress_row_bound=compress_row_bound).stats()
    if noise is not None and noise_seed is not None:
        raise ValueError("pass either a materialized `noise` or `noise_seed`, not both")
    if noise_seed is not None and noise_sigma is None:
        # without this the fused path would default sigma to 0 and silently
        # release UN-noised updates — a privacy-guarantee violation
        raise ValueError("`noise_seed` requires `noise_sigma`")
    from repro_torch.kernels.dp_aggregate import ops, ref

    m, d = raw_updates.shape
    backend = resolve_backend(backend, raw_updates.device,
                              wants_noise_gen=noise_seed is not None)
    if backend == "kernel-fused":
        return ops.dp_aggregate(raw_updates, clip_norm, noise_seed=noise_seed,
                                noise_sigma=noise_sigma, row_start=row_start)
    if noise_seed is not None:
        if backend == "kernel":
            noise = ops.generate_ldp_noise(m, d, noise_seed, noise_sigma,
                                           device=raw_updates.device, row_start=row_start)
        else:
            noise = ref.ldp_noise_ref(m, d, noise_seed, noise_sigma, row_start=row_start,
                                      device=raw_updates.device)
    if backend == "kernel":
        return ops.dp_aggregate(raw_updates, clip_norm, noise)
    return RoundMoments(*ref.dp_aggregate_ref(raw_updates, noise, clip_norm), count=m).stats()


def partial_clip_moments(
    raw_updates: torch.Tensor,
    clip_norm,
    noise: torch.Tensor | None = None,
    *,
    noise_seed: int | None = None,
    noise_sigma=None,
    start=0,
    weight_mask: torch.Tensor | None = None,
    row_weights: torch.Tensor | None = None,
    backend: str = "auto",
    compress_fn=None,
    compress_row_bound=None,
) -> RoundMoments:
    """Clip -> (optional noise) -> the release's PARTIAL SUMS over the rows.

    The moment half of ``fused_clip_aggregate`` (JAX's
    ``partial_clip_moments``).  Noise is a
    materialized (m, d) ``noise`` or drawn from ``noise_seed`` with std
    ``noise_sigma`` for the block's clients: ``start`` (module doc) keys row
    i by its global client index, so any block draws its rows of the whole
    cohort's noise.

    ``weight_mask`` ((m,) float) gates each row: a row whose value is not > 0
    is zeroed with ``where`` (not multiplied) before the clip, its noise too,
    so a NaN there cannot leak; a row with a value > 0 enters ONCE, even a
    with-replacement multiplicity (the reference's documented limitation;
    ``raw_moments`` weights by multiplicity instead).  ``count`` is the sum
    of the mask, or of ``mask * row_weights``; it is the float m when neither
    is given.

    ``row_weights`` ((m,) float) weights each released row after its clip
    and noise (weighted aggregation): ``sum_c = sum_i v_i c_i`` with ``v =
    mask * row_weights``, and the scalar sums alike.  It takes the plain
    path, as the reference's weighted sums take ``jnp``.

    Backends as ``fused_clip_aggregate``'s.  On the card the unweighted
    release is one ``dp_aggregate`` launch with the mask as its ``row_gate``
    (and a gathered block's ids as its ``row_ids``): no pass over the matrix
    besides the kernel's.

    ``compress_fn`` / ``compress_row_bound`` (module doc): the gated raw
    rows are compressed once, the (m, kc) block scaled by the clip scales
    and re-clipped to the bound; ``sum_c`` is its (kc,) sum, the scalar sums
    the dense clipped ones.  It takes the plain path on every device.
    """
    if noise is not None and noise_seed is not None:
        raise ValueError("pass either a materialized `noise` or `noise_seed`, not both")
    if noise_seed is not None and noise_sigma is None:
        raise ValueError("`noise_seed` requires `noise_sigma`")
    if compress_fn is not None and (noise is not None or noise_seed is not None):
        raise ValueError(_COMPRESS_NOISE)
    from repro_torch.kernels.dp_aggregate import ops, ref

    m, d = raw_updates.shape
    dev = raw_updates.device
    backend = resolve_backend(backend, dev, wants_noise_gen=noise_seed is not None)
    if row_weights is not None or compress_fn is not None:
        backend = "torch"
    if weight_mask is None and row_weights is None:
        count = float(m)
    elif row_weights is None:
        count = torch.sum(weight_mask)
    else:
        count = torch.sum(row_weights if weight_mask is None else weight_mask * row_weights)
    keys = row_keys(start, dev) if noise_seed is not None else {}

    if backend in ("kernel", "kernel-fused"):
        kw = {}
        if noise_seed is not None and backend == "kernel-fused":
            kw = dict(noise_seed=noise_seed, noise_sigma=noise_sigma, **keys)
        elif noise_seed is not None:
            noise = ops.generate_ldp_noise(m, d, noise_seed, noise_sigma, device=dev, **keys)
        sums = ops.dp_aggregate_sums(raw_updates, clip_norm, noise, row_gate=weight_mask, **kw)
        return RoundMoments(*sums, count=count)

    if noise_seed is not None:
        noise = ref.ldp_noise_ref(m, d, noise_seed, noise_sigma, device=dev, **keys)
    u = raw_updates.to(torch.float32)
    if weight_mask is not None:
        keep = (weight_mask > 0)[:, None]
        u = torch.where(keep, u, 0.0)
        if noise is not None:
            noise = torch.where(keep, noise, 0.0)
    sq_norms = torch.sum(u * u, dim=-1)
    scale = ref.clip_scale(sq_norms, clip_norm)
    sq_clipped = sq_norms * (scale * scale)
    if compress_fn is not None:
        # the clip scale commutes with the linear map: compress the raw rows,
        # then scale the (m, kc) block, never the (m, d) clipped matrix
        comp = compress_fn(u) * scale[:, None]
        if compress_row_bound is not None:
            comp = comp * ref.clip_scale(torch.sum(comp * comp, dim=-1),
                                         compress_row_bound)[:, None]
        if row_weights is not None:
            v = row_weights if weight_mask is None else weight_mask * row_weights
            sum_sq_clipped = v @ sq_clipped
            return RoundMoments(v @ comp, sum_sq_clipped, sum_sq_clipped, count)
        sum_sq_clipped = torch.sum(sq_clipped)
        return RoundMoments(comp.sum(dim=0), sum_sq_clipped, sum_sq_clipped, count)
    released = u * scale[:, None]
    if noise is not None:
        released = released + noise
    if row_weights is not None:
        v = row_weights if weight_mask is None else weight_mask * row_weights
        sum_sq_clipped = v @ sq_clipped
        sum_sq = sum_sq_clipped if noise is None else v @ torch.sum(released * released, dim=-1)
        return RoundMoments(v @ released, sum_sq, sum_sq_clipped, count)
    sum_sq_clipped = torch.sum(sq_clipped)
    # the dense release's reductions (``ref.dp_aggregate_ref``), so a block
    # with every row in sums what the dense round sums
    sum_sq = sum_sq_clipped if noise is None else torch.sum(released * released)
    return RoundMoments(released.sum(dim=0), sum_sq, sum_sq_clipped, count)


def raw_moments(deltas: torch.Tensor, mask: torch.Tensor | None,
                row_weights: torch.Tensor | None = None, *,
                binary_mask: bool = False, compress_fn=None) -> RoundMoments:
    """Unclipped partial sums (the noiseless names), weighted by the mask.

    Rows whose mask is not > 0 are zeroed with ``where`` first; each other
    row is weighted by its mask value (a with-replacement multiplicity
    counts that many times) times its ``row_weights``; ``count`` is the
    weight sum.  ``mask=None`` is full participation (count m, or the
    weights' sum).

    ``binary_mask``: the caller knows the mask is {0, 1} (a cohort without
    replacement), so gating a row once IS weighting it by its mask.  Then,
    without row weights, a CUDA tensor reduces in one ``dp_aggregate``
    launch (none mode, C = inf, the mask as its gate), as the dense noiseless
    release does; otherwise the sums are plain PyTorch, as in the reference.

    ``compress_fn``: the rows feeding ``sum_c`` are compressed (module doc);
    the scalar sums stay the dense ones, in plain PyTorch on every device.
    """
    m = deltas.shape[0]
    if (deltas.device.type == "cuda" and row_weights is None and compress_fn is None
            and (mask is None or binary_mask)):
        from repro_torch.kernels.dp_aggregate import ops
        sums = ops.dp_aggregate_sums(deltas, math.inf, row_gate=mask)
        return RoundMoments(*sums, count=float(m) if mask is None else torch.sum(mask))
    if mask is None:
        v = row_weights
        count = float(m) if row_weights is None else torch.sum(row_weights)
    else:
        deltas = torch.where((mask > 0)[:, None], deltas, 0.0)
        v = mask if row_weights is None else mask * row_weights
        count = torch.sum(v)
    sq = torch.sum(deltas * deltas, dim=-1)
    rows = deltas if compress_fn is None else compress_fn(deltas)
    if v is None:
        sum_sq = torch.sum(sq)
        return RoundMoments(rows.sum(dim=0), sum_sq, sum_sq, count)
    sum_sq = v @ sq
    return RoundMoments(v @ rows, sum_sq, sum_sq, count)


def streamed_clip_moments(raw_updates: torch.Tensor, clip_norm, noise: torch.Tensor | None = None,
                          *, chunk_clients: int, noise_seed: int | None = None,
                          noise_sigma=None, weight_mask: torch.Tensor | None = None,
                          row_weights: torch.Tensor | None = None,
                          backend: str = "auto", compress_fn=None,
                          compress_row_bound=None) -> RoundMoments:
    """``partial_clip_moments`` over chunks of ``chunk_clients`` rows, the
    moments added chunk by chunk (``add_moments``).

    The reference of the streaming engine's reduction for a caller that
    holds the whole (M, d) matrix: the chunks are those of
    ``kernels.dp_aggregate.ref.chunk_grid``, chunk j rows ``[j c, (j + 1)
    c)`` keyed from ``j c`` (``noise_seed``), a padded last chunk's padding
    at mask 0; a materialized ``noise``, the mask and the weights are cut
    the same way.  Only the association of the sums changes at chunk
    boundaries; one chunk (``chunk_clients >= M``) is
    ``partial_clip_moments`` itself.  ``count`` is the un-chunked entry's:
    the mask's (or mask times weights') sum, or the float M without either.
    ``compress_fn`` / ``compress_row_bound`` go to every chunk, whose (kc,)
    compressed sums add like dense ones.
    """
    from repro_torch.kernels.dp_aggregate.ref import chunk_grid, grid_rows
    if chunk_clients < 1:
        raise ValueError(f"chunk_clients must be >= 1, got {chunk_clients}")
    m = raw_updates.shape[0]
    c = min(chunk_clients, m)
    if weight_mask is None and m % c:
        weight_mask = raw_updates.new_ones(m)
    total = None
    for j0, idx, valid in chunk_grid(m, c):
        u, noise_j, mask, weights = (None if x is None else grid_rows(x, j0, idx)
                                     for x in (raw_updates, noise, weight_mask, row_weights))
        if j0 + c > m:
            mask = mask * valid.to(mask.device)
        mom = partial_clip_moments(u, clip_norm, noise_j, noise_seed=noise_seed,
                                   noise_sigma=noise_sigma, start=j0, weight_mask=mask,
                                   row_weights=weights, backend=backend,
                                   compress_fn=compress_fn,
                                   compress_row_bound=compress_row_bound)
        total = mom if total is None else add_moments(total, mom)
    return total
