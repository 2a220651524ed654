"""Declarative run specs (counterpart of repro/fedsim/specs.py).

The port runs the local trainers of ``LocalSpec`` (full-batch GD, minibatch
SGD over local epochs, FedProx, client momentum, and SCAFFOLD's
control-variate steps) and three round loops, eager, scan (CUDA graphs) and
streamed (``EngineSpec``; ``StreamSpec`` sets the stream's client chunk),
observed by ``TelemetrySpec`` and ``run(tracker=)``, with full
participation or a sampled cohort (``CohortSpec``), under an optional fault
model and divergence watchdog (``FaultSpec``), on client data on the device
or behind a host, disk or generated source (``DataSpec``), and with the
cohort split over the ranks of a ``torch.distributed`` client mesh
(``ShardSpec``).  The JAX package's ``SAMPLING_TAG`` (the tag a round key is
folded with for its cohort mask) has no counterpart: the port draws the mask
from the round's CPU generator (``CohortSpec.round_mask``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.compression import COMPRESS_TAG

__all__ = ["TrainSpec", "LocalSpec", "EngineSpec", "ShardSpec", "StreamSpec", "CohortSpec",
           "FaultSpec", "TelemetrySpec", "DataSpec", "FAULT_TAG", "LOCAL_TRAIN_TAG", "COMPRESS_TAG"]

# the tag of a round's fault draws (dropouts, straggler cutoffs, corrupted
# updates): each fault class draws from a generator of its own keyed by the
# round's seed, this tag and the class (``fedsim.faults.fault_masks``), so
# fault draws never shift the cohort mask or the noise of the round.  The
# JAX package's value: 2**31 - 1 and 2**31 - 2 tag sampling and local
# training there, and no client index reaches them.
FAULT_TAG = 2**31 - 3
# the tag of a round's local-training shuffles (minibatch ``LocalSpec``):
# client i's epoch-e shuffle is keyed by the round's seed, this tag, i (its
# global index) and e (``fedsim.local.local_shuffles``).  The JAX package's
# value.
LOCAL_TRAIN_TAG = 2**31 - 2
# COMPRESS_TAG, the tag of a round's compression plan (rand-k indices,
# sketch tables), is defined beside the compressors (``core.compression``)
# and re-exported here with the rest of the tag family.


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """What to train: the paper-level knobs of one federated run."""

    rounds: int                 # T server rounds
    tau: int                    # local GD steps per client per round
    eta_l: float                # client learning rate
    avg_last: int = 2           # §5 iterate average over the trailing iterates
    eval_every: int = 1         # eval cadence; non-eval rounds record NaN

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.avg_last < 1:
            raise ValueError(f"avg_last must be >= 1, got {self.avg_last}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """How each client trains locally.

    The default (all fields at rest) is the full-batch GD of Algorithm 3:
    ``tau`` steps on the whole client batch.  ``control_variates=True`` is
    SCAFFOLD's trainer: ``tau`` full-batch steps of ``g - c_i + c``, the
    per-client and global control variates coming from the algorithm
    (``make_algorithm("dp-scaffold", ...)``).  Otherwise
    (``fedsim.local.local_update_spec``): with ``batch_size`` set, each
    client runs ``epochs x (n // batch_size)`` minibatch steps over a fresh
    shuffle of its n samples each epoch (the remainder is dropped), else
    ``tau`` full-batch steps; ``prox_mu`` adds FedProx's
    ``prox_mu * (w - w0)`` to each gradient; ``momentum`` steps by a
    velocity that starts at zero every round.
    """

    batch_size: int | None = None   # None = full batch
    epochs: int = 1                 # local epochs when batch_size is set
    prox_mu: float = 0.0            # FedProx proximal coefficient
    momentum: float = 0.0           # client momentum over the local steps
    control_variates: bool = False  # SCAFFOLD steps g - c_i + c

    def __post_init__(self):
        if self.batch_size is not None and self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if self.epochs > 1 and self.batch_size is None:
            raise ValueError("epochs > 1 requires batch_size (full-batch GD "
                             "counts steps with TrainSpec.tau)")
        if self.prox_mu < 0.0:
            raise ValueError(f"prox_mu must be >= 0, got {self.prox_mu}")
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got {self.momentum}")
        if self.control_variates and not (
                self.batch_size is None and self.epochs == 1
                and self.prox_mu == 0.0 and self.momentum == 0.0):
            raise ValueError(
                "control_variates is the full-batch SCAFFOLD trainer "
                "(tau steps of g - c_i + c, matching the option-II variate "
                "refresh scale 1/(tau*eta_l)); it does not compose with "
                "minibatch/prox/momentum fields")

    @property
    def is_default(self) -> bool:
        """True when this spec is exactly the full-batch GD of Algorithm 3."""
        return (self.batch_size is None and self.epochs == 1
                and self.prox_mu == 0.0 and self.momentum == 0.0
                and not self.control_variates)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How the round loop runs.

    * ``"scan"`` (the default, as in the JAX package, and its compiled
      scan's counterpart): each round is staged on the host, then replayed
      from a CUDA graph captured once per round kind and reused by every run
      and seed of the session (``fedsim/scan.py``); on the CPU the same stage
      and body run uncaptured.  ``chunk_rounds`` splits a run into chunks
      whose histories (and telemetry payloads) the host reads once a chunk
      (None = one chunk); ``scan_unroll`` is the number of rounds one graph
      holds.  Results are the same bits for every value of either, and the
      eager engine's bits.  The engine always works in buffers of its own
      and never writes the caller's tensors, so ``donate`` (the JAX
      package's carry donation) is accepted and changes nothing.  A round
      kind's first round pays a warm-up and a capture, and a host hook of
      the run loop acts only at chunk edges.
    * ``"eager"``: a plain Python loop of rounds that trains the whole
      cohort (or its gathered block) at once, each round's stage and body
      run uncaptured.  It takes no ``ShardSpec``.
    * ``"stream"``: the eager loop with each round walking the cohort in
      chunks of ``StreamSpec.chunk_clients`` clients, so that one (chunk, d)
      block of updates is live at a time and the client data may stay on the
      host (``fedsim/server.py::stream_round_step``).
    """

    engine: str = "scan"            # "scan" | "eager" | "stream"
    chunk_rounds: int | None = None  # rounds per chunk (None = all)
    scan_unroll: int = 2            # rounds captured in one graph
    donate: bool | None = None      # the JAX package's carry donation; no effect here

    def __post_init__(self):
        if self.engine not in ("scan", "eager", "stream"):
            raise ValueError(f"unknown engine {self.engine!r}; "
                             "use 'scan', 'eager', or 'stream'")
        if self.chunk_rounds is not None and self.chunk_rounds < 1:
            raise ValueError(f"chunk_rounds must be >= 1, got {self.chunk_rounds}")
        if self.scan_unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {self.scan_unroll}")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Where the cohort lives: optional client sharding over the ranks of a
    ``torch.distributed`` group.

    ``mesh`` is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` whose one
    dimension is named ``client_axis`` (``launch.mesh.make_client_mesh``).
    Every rank builds the same session on the whole cohort; rank r trains
    and releases only its slice of it, the padded cohort's rows ``[r m_local,
    (r + 1) m_local)``, and one ``all_reduce`` of the round's moments a round
    puts the same server update on every rank.  None is the unsharded run.
    """

    mesh: object | None = None      # DeviceMesh | None
    client_axis: str = "clients"

    @property
    def n_shards(self) -> int:
        """The number of ranks the cohort is split over (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return self.mesh.size(self._dim())

    @property
    def rank(self) -> int:
        """This process's index along the client axis (0 without a mesh)."""
        if self.mesh is None:
            return 0
        return self.mesh.get_local_rank(self.client_axis)

    @property
    def group(self):
        """The process group of the client axis (None without a mesh)."""
        return None if self.mesh is None else self.mesh.get_group(self.client_axis)

    def _dim(self) -> int:
        names = tuple(getattr(self.mesh, "mesh_dim_names", None) or ())
        if self.mesh.ndim != 1 or names != (self.client_axis,):
            raise ValueError(
                f"ShardSpec needs a 1-D mesh whose dimension is named {self.client_axis!r}, got "
                f"dimensions {names or None} (make_client_mesh(axis={self.client_axis!r}))")
        return 0

    def describe(self) -> str:
        """The shard part of ``spec_identity``, the JAX package's string."""
        if self.mesh is None:
            return f"shard=mesh[none] axis={self.client_axis}"
        return f"shard=mesh[{self.client_axis}={self.n_shards}] axis={self.client_axis}"


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """The client chunk of the streaming engine (``EngineSpec(engine="stream")``).

    Each round walks the cohort in chunks of ``chunk_clients`` clients:
    local training and the release see one (chunk_clients, d) block at a
    time, and only the O(d) moments (sums) carry across chunks, so the peak
    update memory is chunk-sized, not cohort-sized.  Chunk j holds the
    global clients ``[j c, (j + 1) c)``; the rows that pad M up to the grid
    repeat client 0 and carry mask 0.  Every per-client draw is keyed by
    global client index, so a streamed round releases what the eager round
    releases, re-associated at chunk boundaries (rtol 1e-5).

    ``chunk_clients`` is an int >= 1, or ``"auto"``: the largest chunk that
    fits a quarter of the card's memory, resolved when the session is built
    (``launch.mesh.auto_chunk_clients``) and recorded on
    ``session.stream``.
    """

    chunk_clients: int | str = 1024

    def __post_init__(self):
        if isinstance(self.chunk_clients, str):
            if self.chunk_clients != "auto":
                raise ValueError(f"chunk_clients must be an int >= 1 or 'auto', "
                                 f"got {self.chunk_clients!r}")
        elif self.chunk_clients < 1:
            raise ValueError(f"chunk_clients must be >= 1, got {self.chunk_clients}")

    @property
    def is_auto(self) -> bool:
        """True when the chunk is derived from the card's memory budget."""
        return self.chunk_clients == "auto"


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Who participates each round: per-round client sampling.

    ``q=1.0`` and ``size=None`` (the default) is full participation and takes
    the unsampled round, bit for bit.  ``q < 1`` is per-round Bernoulli
    (Poisson) sampling; ``size=k`` a uniform cohort of exactly k, with
    multiplicities when ``replace``.  ``gather=True`` trains only the
    sampled clients: the mask is packed into a static ``(cap,)`` slot table
    (``fedsim.local.gather_slots``) and local training runs on that block.
    ``cap`` is the fixed ``size``, else ``gather_cap``, else a Bernoulli
    bound (``resolved_cap``).  Randomness is keyed by global client index,
    so a gathered round equals the dense one at rtol 1e-5; participants
    beyond the cap are dropped from the round.
    """

    q: float = 1.0              # Bernoulli participation probability
    size: int | None = None     # fixed cohort size (exclusive with q < 1)
    replace: bool = False       # fixed-size sampling with replacement
    gather: bool = False        # train only the sampled clients
    gather_cap: int | None = None  # static slot-table size; None = derived

    def __post_init__(self):
        if not (0.0 < self.q <= 1.0):
            raise ValueError(f"q must be in (0, 1], got {self.q}")
        if self.size is not None and self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size}")
        if self.q < 1.0 and self.size is not None:
            raise ValueError("specify q<1 (Bernoulli) OR size (fixed), not both")
        if self.replace and self.size is None:
            raise ValueError("replace=True requires a fixed cohort size")
        if self.gather and not self.is_sampled:
            raise ValueError("gather=True requires sampling (q < 1 or size=k); "
                             "a full-participation round has nothing to skip")
        if self.gather and self.replace:
            # a multiplicity mask gates a row once in the clipped sums; a
            # gathered block would need duplicated rows to stay exact
            raise ValueError("gather=True does not support replace=True "
                             "(multiplicity-weighted cohorts); drop gather or "
                             "sample without replacement")
        if self.gather_cap is not None:
            if self.gather_cap < 1:
                raise ValueError(f"gather_cap must be >= 1, got {self.gather_cap}")
            if not self.gather:
                raise ValueError("gather_cap requires gather=True")

    @property
    def is_sampled(self) -> bool:
        """True when this spec subsamples (q < 1 or a fixed size)."""
        return self.q < 1.0 or self.size is not None

    def resolved_cap(self, num_clients: int) -> int:
        """Static slot-table size of the gathered block for M clients: the
        fixed size; else ``gather_cap``; else ``qM + 6 sqrt(qM) + 16`` (about
        six standard deviations of headroom and a small-M floor), at most M."""
        if self.size is not None:
            return min(self.size, num_clients)
        if self.gather_cap is not None:
            return min(self.gather_cap, num_clients)
        qm = self.q * num_clients
        return min(num_clients, int(math.ceil(qm + 6.0 * math.sqrt(qm) + 16.0)))

    def sampling_rate(self, num_clients: int) -> float:
        """Expected per-round participation fraction (for accounting)."""
        if self.size is not None:
            return min(1.0, self.size / float(num_clients))
        return self.q

    def round_mask(self, gen: torch.Generator, num_clients: int) -> torch.Tensor:
        """(num_clients,) float32 participation mask on the host, drawn from
        the round's CPU generator: {0, 1} (Bernoulli, or a uniform size-subset
        from a random permutation) or multiplicities summing to ``size``
        (with replacement)."""
        if self.size is not None:
            if self.replace:
                idx = torch.randint(0, num_clients, (self.size,), generator=gen)
                return torch.bincount(idx, minlength=num_clients).to(torch.float32)
            perm = torch.randperm(num_clients, generator=gen)
            return (perm < self.size).to(torch.float32)
        return (torch.rand(num_clients, generator=gen) < self.q).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What goes wrong each round: fault injection and the divergence watchdog.

    The default (all fields at rest) is a fault-free run; the session
    normalizes it to None, so a ``FaultSpec()`` session runs the unfaulted
    round loop bit for bit.  Any nonzero rate routes every round through
    the masked-moment protocol with that round's fault draws, keyed by the
    round's seed and global client index (``fedsim.faults.fault_masks``).

    Injection (per round, per client, independent):

    * ``dropout``: the client drops out; its update becomes a zero-weight
      row, and the realized count shrinks.
    * ``straggler`` and ``straggler_steps``: the client misses the deadline
      after ``straggler_steps`` of the ``tau`` local steps; its partial
      update still aggregates.
    * ``corrupt``: the client returns a non-finite update (NaN rows); the
      server's finite screen zero-weights it.

    Detection:

    * ``watchdog``: after each round, a non-finite global model or a step
      size that is NaN or above ``eta_max`` trips it: the round is not
      committed, the remaining rounds are skipped with NaN histories, and
      ``RunResult.fault_round`` records the round.  It reads the device once
      a round.  ``session.run(on_divergence=RecoveryPolicy(...))`` turns a
      trip into rollback and retry.
    """

    dropout: float = 0.0        # P(client drops out of a round)
    straggler: float = 0.0      # P(client misses the deadline)
    straggler_steps: int = 1    # local steps a straggler completes (< tau)
    corrupt: float = 0.0        # P(surviving client returns non-finite rows)
    watchdog: bool = False      # arm the divergence watchdog
    eta_max: float = 1e6        # watchdog: eta_g above this = divergence

    def __post_init__(self):
        for field in ("dropout", "straggler", "corrupt"):
            v = getattr(self, field)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{field} must be in [0, 1), got {v}")
        if self.straggler_steps < 1:
            raise ValueError(
                f"straggler_steps must be >= 1, got {self.straggler_steps}")
        if not self.eta_max > 0.0:
            raise ValueError(f"eta_max must be > 0, got {self.eta_max}")

    @property
    def injects(self) -> bool:
        """True when this spec perturbs rounds (any nonzero rate)."""
        return self.dropout > 0.0 or self.straggler > 0.0 or self.corrupt > 0.0

    @property
    def is_active(self) -> bool:
        """True when the round loop must differ from the unfaulted one
        (injection or the watchdog); ``FaultSpec()`` normalizes to None."""
        return self.injects or self.watchdog


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """How a run is observed (a copy of the JAX package's spec).

    The spec never changes what a round computes: the engines learn only
    whether a tracker is attached (``run(tracker=...)``), and a tracked run
    equals an untracked one in bits.

    Attributes:
      ledger_delta: the delta at which the cumulative privacy ledger is
        evaluated (``session._budget_at(ledger_delta, rounds_executed)``
        added to every round event); None disables ledger events.  A
        session whose algorithm has no budget skips the ledger.
      profile_rounds: an optional ``(a, b)`` half-open window of rounds
        wrapped in ``torch.profiler`` (the scan engine splits its chunks at
        a and b); None = off.
      profile_dir: where the profiler writes its trace; recorded in the
        profile_start / profile_stop tracker events.
    """

    ledger_delta: float | None = 1e-5
    profile_rounds: tuple[int, int] | None = None
    profile_dir: str = "results/profile"

    def __post_init__(self):
        if self.ledger_delta is not None and not (0.0 < self.ledger_delta < 1.0):
            raise ValueError(
                f"ledger_delta must be in (0, 1) or None, got {self.ledger_delta}")
        if self.profile_rounds is not None:
            a, b = self.profile_rounds
            if not (0 <= a < b):
                raise ValueError("profile_rounds must be (a, b) with "
                                 f"0 <= a < b, got {self.profile_rounds}")


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Where the client data lives and how it reaches the card.

    The session derives it from what it is given: tensors or arrays (or an
    ``ArraySource``) are ``kind="device"``, moved to the card whole; a
    ``ClientDataSource`` (``fedsim.data``) reports its own kind.  Data that
    is not device-resident streams (``EngineSpec(engine="stream")``): each
    chunk's rows are fetched on the host and copied to the card, with
    ``prefetch`` chunks staged ahead of the chunk being trained.

    Attributes:
      kind: ``"device"``, ``"host"`` (numpy arrays in host memory),
        ``"npz"`` (an archive on disk) or ``"synthetic"`` (generated per
        fetch).  Validated only: the session derives the kind from the
        data and refuses a ``kind`` that contradicts it, as the JAX
        package does; setting it changes nothing else.
      prefetch: chunks in flight ahead of the one being trained (>= 1; 2 is
        double buffering).  Device-resident data ignores it.
    """

    kind: str = "device"
    prefetch: int = 2

    def __post_init__(self):
        if self.kind not in ("device", "host", "npz", "synthetic"):
            raise ValueError(f"unknown data kind {self.kind!r}; use 'device', "
                             "'host', 'npz', or 'synthetic'")
        if self.prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {self.prefetch}")
