"""Server-algorithm contract and the round's randomness (counterpart of
repro/core/algorithm.py).

A round's randomness comes from one CPU ``torch.Generator`` seeded from the
run's seed and the round index (``round_generator``).  Before the round
runs, the algorithm draws from it everything its release consumes into a
``RoundNoise``: host values (the kernel's 32-bit noise seed, the CDP
numerator noise, PrivUnit's per-client scalars, the clip-bit noise) come
straight from it, device tensors from a device generator seeded by it.  Tests pass a ``RoundNoise`` of their own to replay
the JAX package's noise exactly.  A sampled round draws its cohort mask
first (``CohortSpec.round_mask``), then the algorithm's noise for the whole
cohort of M clients, so a gathered block of clients reads its rows of the
same draws as the dense round.

The round is a host stage and a device body.  The stage draws the
``RoundNoise`` and puts it in the form the body reads
(``ServerAlgorithm.stage_noise``): every field a tensor on the device (the
seeds as 0-d int64, PrivUnit's quantiles computed on the host in float64
and copied over, a round-indexed schedule's sigma(t) as a 0-d tensor).  The
body then reads only device memory, so the scan engine can replay it from a
CUDA graph (``fedsim/scan.py``): ``host_to_device`` refuses to run while a
graph is being captured.

A client-sharded round (``fedsim.specs.ShardSpec``) is the masked-moment
protocol across the ranks of a ``torch.distributed`` group: each rank's
``local_moments`` over its slice of the cohort, one ``all_reduce_moments``
(one collective of one flat float32 buffer), then the same
``apply_from_moments`` on every rank: the engine's
``fedsim.server.masked_round`` with ``shard=``, and
``ServerAlgorithm.apply_round_sharded`` for one full-participation round
on given updates (the JAX package's method).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.aggregation import RoundMoments, global_client_indices
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "RoundAux",
    "RoundNoise",
    "ServerAlgorithm",
    "round_generator",
    "device_generator",
    "device_normal",
    "draw_seed32",
    "host_to_device",
    "stage_tensor",
    "device_copy",
    "rows_at",
    "set_moment_count",
    "clamp_moment_counts",
    "all_reduce_moments",
    "stage_fields",
]


def round_generator(seed: int, t: int) -> torch.Generator:
    """The CPU generator of round ``t`` of the run seeded ``seed`` (both >= 0)."""
    state = np.random.SeedSequence([int(seed), int(t)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def draw_seed32(gen: torch.Generator) -> int:
    """One uniform 32-bit seed from ``gen`` (a host integer: no device sync)."""
    return int(torch.randint(0, 2**32, (), generator=gen, dtype=torch.int64))


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """The generator that draws on ``device``: ``gen`` itself on the CPU, else
    a generator there seeded by one draw from ``gen``."""
    device = torch.device(device)
    if device.type == "cpu":
        return gen
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(int(torch.randint(0, 2**63 - 1, (), generator=gen)))
    return dev_gen


def device_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """float32 N(0, 1) of ``shape`` on ``device``, drawn there from a
    generator seeded by ``gen`` (the CPU draws directly from ``gen``)."""
    return torch.randn(shape, generator=device_generator(gen, device), device=device)


def host_to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``, copied from pinned memory without waiting
    for the device (a pageable copy would synchronise the stream).

    It raises while the current stream captures a CUDA graph: the graph
    would replay this round's host values in every later round.  Such a
    value belongs in the round's stage."""
    device = torch.device(device)
    if x.device.type == device.type:
        return x
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"host_to_device of a {tuple(x.shape)} {x.dtype} host tensor while a CUDA graph is "
            "being captured: the graph would replay this round's host values forever; the "
            "value belongs in the round's stage")
    return x.pin_memory().to(device, non_blocking=True)


def stage_tensor(x, device, dtype=None) -> torch.Tensor:
    """A round's host value as the body reads it: a tensor on ``device``
    (a Python int as 0-d int64, a float as 0-d float32)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=dtype or (torch.int64 if isinstance(x, int) else torch.float32))
    return host_to_device(x, device)


def device_copy(owner, name: str, host: torch.Tensor, device) -> torch.Tensor:
    """A copy of the constant host tensor ``host`` on ``device``, cached on
    ``owner`` (a frozen dataclass too) under ``name``: made the first time a
    round asks for it, before any graph is captured, and read by every round
    after."""
    device = torch.device(device)
    if device.type == host.device.type:
        return host
    cache = owner.__dict__.setdefault("_device_copies", {})
    key = (name, str(device))
    if key not in cache:
        cache[key] = host_to_device(host, device)
    return cache[key]


def rows_at(x: torch.Tensor, start, m: int) -> torch.Tensor:
    """The rows of a per-client (M, ...) tensor that a block of m clients at
    ``start`` owns (``global_client_indices``): a slice for a contiguous
    block, a gather for a gathered one (indices copied to ``x``'s device).
    A contiguous block that runs past M (a streamed round's last chunk,
    padded to the grid) gets zero rows there."""
    if not isinstance(start, torch.Tensor):
        if start == 0 and x.shape[0] == m:
            return x
        rows = x[start:start + m]
        if rows.shape[0] < m:
            rows = torch.cat([rows, rows.new_zeros((m - rows.shape[0],) + tuple(x.shape[1:]))])
        return rows
    return x.index_select(0, global_client_indices(start, m, x.device))


@dataclasses.dataclass
class RoundNoise:
    """Everything random that one round's release consumes."""

    seed: int | None = None                 # 32-bit seed of the per-client LDP noise
                                            # (Gaussian, or PrivUnit's normal)
    ldp: torch.Tensor | None = None         # (M, d) materialized per-client noise
    central: torch.Tensor | None = None     # (d,) N(0, 1) of the CDP mean ((kc,) compressed)
    # DP-SCAFFOLD's second release (the variate update), drawn after the
    # first: its LDP seed or (M, d) matrix, or its CDP (d,) N(0, 1)
    seed_dc: int | None = None
    ldp_dc: torch.Tensor | None = None
    central_dc: torch.Tensor | None = None
    xi: torch.Tensor | None = None          # N(0, 1) of the CDP FedEXP numerator
    # PrivUnit: (M,) host uniforms of the cap and its quantile (the stage
    # turns them into ``quantile``), ScalarDP's (M,) rounding and keep
    # uniforms and integers in [0, k), and a materialized (M, d) N(0, 1) in
    # place of the normal keyed by ``seed``
    cap_u: torch.Tensor | None = None
    u01: torch.Tensor | None = None
    g: torch.Tensor | None = None
    round_u: torch.Tensor | None = None
    keep_u: torch.Tensor | None = None
    u_int: torch.Tensor | None = None
    bit: torch.Tensor | None = None         # N(0, 1) of the adaptive clip's bit sum
    # a compressed aggregation's plan on the device: rand-k's (k,) indices, or
    # the sketch's (h, s) tables (a ``compression.SketchPlan``)
    plan: object = None
    # set by the stage (``ServerAlgorithm.stage_noise``), which every release
    # reads: PrivUnit's (M,) float32 quantiles in place of cap_u and u01, and
    # a round-indexed noise schedule's sigma(t) as a 0-d float32 tensor
    quantile: torch.Tensor | None = None
    sigma_t: torch.Tensor | None = None


def stage_fields(noise: RoundNoise, device, **extra) -> RoundNoise:
    """``noise`` with ``extra`` set and every int and tensor field on
    ``device`` (seeds as 0-d int64 tensors); other fields as they are."""
    out = {}
    for f in dataclasses.fields(RoundNoise):
        v = extra[f.name] if f.name in extra else getattr(noise, f.name)
        if isinstance(v, (int, torch.Tensor)) and not isinstance(v, bool):
            v = stage_tensor(v, device)
        out[f.name] = v
    return RoundNoise(**out)


def _map_moments(moments, fix):
    """``fix`` applied to every RoundMoments in ``moments`` (a RoundMoments or
    a tuple holding some)."""
    def one(x):
        return fix(x) if isinstance(x, RoundMoments) else x

    return tuple(one(x) for x in moments) if isinstance(moments, tuple) else one(moments)


def set_moment_count(moments, m_total: int):
    """Swap the count of every RoundMoments in ``moments`` for the statically
    known client count (the fixed cohort size of a sampled round)."""
    return _map_moments(moments, lambda x: dataclasses.replace(x, count=float(m_total)))


def clamp_moment_counts(moments, floor: float = 1.0):
    """Clamp every RoundMoments count to >= ``floor``, on the device.

    A Bernoulli cohort can be empty: its sums are 0, and a count of 1 makes
    the round a zero update instead of NaN.  A weighted count is a weight
    sum that may be below 1; its caller passes a tiny floor that only guards
    the empty round."""
    def clamp(x):
        c = x.count
        c = torch.clamp(c, min=floor) if isinstance(c, torch.Tensor) else max(float(c), floor)
        return dataclasses.replace(x, count=c)

    return _map_moments(moments, clamp)


def _summable(x) -> bool:
    """Whether a leaf of a round's moments is a sum that the ranks add."""
    return isinstance(x, (torch.Tensor, float, int)) and not isinstance(x, bool)


def _fields(x) -> tuple:
    """A ``RoundMoments``' fields in order; any other leaf alone."""
    if isinstance(x, RoundMoments):
        return tuple(getattr(x, f.name) for f in dataclasses.fields(RoundMoments))
    return (x,)


def all_reduce_moments(moments, group=None, device=None):
    """The sum over the ranks of ``group`` of a round's moments: every leaf
    (a ``RoundMoments``' sums and count, the extras: PrivUnit's sum of
    s_hat, the clip-bit count, a weighted round's client count and sum of
    sigma_i^2, DP-SCAFFOLD's variate sums) packed into one flat float32
    buffer, one ``torch.distributed.all_reduce`` (SUM) of it, and unpacked:
    the one collective of a sharded round.  A float leaf (a block's static
    count) comes back a 0-d tensor.  ``device``: where the buffer lives when
    no leaf is a tensor.  Each call adds one to ``all_reduce_moments.launches``
    (the scan engine's replays add their captured count)."""
    import torch.distributed as dist

    leaves = [v for x in tree_leaves(moments) for v in _fields(x) if _summable(v)]
    dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)), device)
    flat = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.float32:
                raise TypeError(f"a round's moments are float32; a {x.dtype} leaf would not "
                                "survive the float32 all-reduce in bits")
            flat.append(x.reshape(-1))
        else:
            flat.append(torch.full((1,), float(x), dtype=torch.float32, device=dev))
    buf = torch.cat(flat)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    all_reduce_moments.launches += 1
    it = iter(torch.split(buf, [v.numel() for v in flat]))

    def take(v):
        if not _summable(v):
            return v
        return next(it).reshape(tuple(v.shape) if isinstance(v, torch.Tensor) else ())

    return tree_map(lambda x: RoundMoments(*map(take, _fields(x))) if isinstance(x, RoundMoments)
                    else take(x), moments)


all_reduce_moments.launches = 0


@dataclasses.dataclass
class RoundAux:
    """Diagnostics for one round; diagnostics not produced are NaN, not None."""

    eta_g: torch.Tensor
    eta_naive: torch.Tensor | None = None   # Eq. (3), for the Fig. 2 ablation
    eta_target: torch.Tensor | None = None  # Eq. (5), oracle diagnostic
    update_norm: torch.Tensor | None = None

    def __post_init__(self):
        self.eta_g = torch.as_tensor(self.eta_g, dtype=torch.float32)
        for f in ("eta_naive", "eta_target", "update_norm"):
            if getattr(self, f) is None:
                setattr(self, f, torch.full((), float("nan"), device=self.eta_g.device))


class ServerAlgorithm:
    """Base class; subclasses set ``name`` and implement ``apply_round_stateful``.

    A dense round is ``apply_round_stateful(gen, w, raw_deltas, state, noise, t)``:
    ``gen`` is the round's generator, ``raw_deltas`` the (M, d) unclipped
    local updates, ``state`` the server carry (``init_state``), ``noise``
    an optional ``RoundNoise`` that replaces the draws from ``gen``, and
    ``t`` the round index (read by round-indexed noise schedules).

    A sampled round is the masked-moment protocol, two halves around the
    round's ``RoundNoise`` (``draw_noise`` for all M clients):

        local_moments(noise, w, deltas, mask, start, state, t)  -> SUMS
        apply_from_moments(noise, w, moments, state, t)         -> (w', aux, state)

    ``deltas`` are the (m, d) rows of a block of clients at ``start`` (the
    global index of row 0, or a (m,) host tensor of global indices), ``mask``
    their (m,) participation weights.  The moments are sums, so blocks add.
    """

    name: str = "base"
    is_private: bool = True
    # the count of a RoundMoments is the number of participating clients, so
    # a sampled round may replace it with the fixed cohort size; weighted
    # aggregation (count = a weight sum) sets this False
    supports_static_count: bool = True

    def comm_floats(self, d: int) -> int:
        """Floats one client uploads and the round reduces (the communication
        model): ``sum_c`` and the three scalar moments by default; a
        compressed composition's payload is O(k) or O(width * depth)."""
        return d + 3

    def init_state(self, w: torch.Tensor):
        """Initial server carry for a run starting from ``w``."""
        return ()

    def draw_noise(self, gen: torch.Generator, m: int, d: int, device, t=None) -> RoundNoise:
        """All randomness of round ``t``, drawn from ``gen`` in a fixed order."""
        return RoundNoise()

    def stage_noise(self, noise: RoundNoise, device, t=None) -> RoundNoise:
        """``noise`` in the form the round's body reads: every int and host
        tensor field on ``device`` (``stage_tensor``); the plan as it is."""
        return stage_fields(noise, device)

    def apply_round_stateful(self, gen, w, raw_deltas, state, noise: RoundNoise | None = None,
                             t=None):
        """One dense round: ``-> (w_next, RoundAux, state)``."""
        raise NotImplementedError

    def local_moments(self, noise: RoundNoise, w, deltas, mask, start, state, t=None, *,
                      binary_mask: bool = False):
        """Partial sums of this algorithm's release over a block of clients."""
        raise NotImplementedError(f"{self.name} has no masked-moment round")

    def apply_from_moments(self, noise: RoundNoise, w, moments, state, t=None):
        """The server update from the cohort's moments: ``-> (w_next, RoundAux, state)``."""
        raise NotImplementedError(f"{self.name} has no masked-moment round")

    def apply_round_sharded(self, noise: RoundNoise, w, deltas, mask, start, state, group,
                            m_total: int | None = None, t=None):
        """One full-participation round on a rank's slice of the cohort:
        ``-> (w_next, RoundAux, state)``, the same on every rank.

        ``deltas`` are the rank's (m_local, d) rows, whose first client is
        ``start``; ``mask`` None (no padding row) or its (m_local,) {0, 1}
        padding mask.  The slice's ``local_moments`` cross the ranks of
        ``group`` in one ``all_reduce_moments``; ``m_total`` (the static true
        client count M) replaces the reduced count when the count is a
        client count, as the unsharded dense round divides by M; then
        ``apply_from_moments``.  At one rank this is the dense round's
        release, sum for sum."""
        moments = self.local_moments(noise, w, deltas, mask, start, state, t, binary_mask=True)
        moments = all_reduce_moments(moments, group, w.device)
        if m_total is not None and self.supports_static_count:
            moments = set_moment_count(moments, m_total)
        return self.apply_from_moments(noise, w, moments, state, t)

    def apply_round(self, gen, w, raw_deltas, noise: RoundNoise | None = None, t=None):
        """One dense round from a fresh carry: ``-> (w_next, RoundAux)``."""
        w_next, aux, _ = self.apply_round_stateful(gen, w, raw_deltas, self.init_state(w),
                                                   noise, t)
        return w_next, aux
