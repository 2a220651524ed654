"""The production and test meshes, the client mesh and the streaming
engine's device memory sizing (counterpart of repro/launch/mesh.py).

``make_production_mesh`` is the datacenter layout of DESIGN.md §4: 16 x 16
cards as ("data", "model"), or 2 x 16 x 16 as ("pod", "data", "model") on
two pods; ``make_test_mesh(data, model)`` is a small one.  Each is a
``DeviceMesh`` over the ranks of the current process group, one card a rank,
and refuses a group of another size.  The dry-run (``launch/dryrun.py``)
lays a model out on them from a process of its own with a fake group of
256 or 512 ranks (``fake_process_group``), as the JAX dry-run forces 512
host devices.

The client mesh splits a federated cohort over the ranks of a
``torch.distributed`` group, one card a rank (``make_client_mesh``,
``client_shard_spec`` for ``FederatedSession(..., shard=)``);
``auto_shard_count`` caps the ranks so that every slice keeps
``MIN_CLIENTS_PER_SHARD`` clients.  ``auto_chunk_clients`` resolves
``StreamSpec(chunk_clients="auto")``: the largest client chunk whose update
block, noise block and staged data fit the memory budget of
``device_memory_budget``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["MIN_CLIENTS_PER_SHARD", "make_production_mesh", "make_test_mesh",
           "fake_process_group", "make_client_mesh", "auto_shard_count",
           "client_shard_spec", "device_memory_budget", "auto_chunk_clients"]

BUDGET_FRACTION = 0.25         # of the device's memory, for one chunk
CPU_FALLBACK_BYTES = 4 << 30   # the JAX package's documented host budget
# the fewest clients a shard keeps under the "auto" shard count: the JAX
# package's value (a rank's per-round collective outweighs a thinner slice)
MIN_CLIENTS_PER_SHARD = 24


def _world() -> int:
    """The ranks of the default process group (1 when there is none): one
    card a rank, so this is the devices a client mesh can span."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _grid_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str | None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every rank of the
    current process group, whose size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"a {' x '.join(map(str, shape))} mesh spans {n} ranks, but there is no "
                "process group: start one process a card and call torch.distributed."
                "init_process_group first (or, to lay a model out without cards, a fake "
                "group: launch.mesh.fake_process_group)")
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs {n} ranks, the process "
                         f"group has {world}: the mesh is not shrunk to fit")
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16 x 16 = 256 cards a pod as ("data", "model"); two pods, 512 cards,
    with a leading "pod" axis.  ``device_type``: the mesh's device type
    (default: "cuda" over an NCCL group, else "cpu")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, *, device_type: str | None = None):
    """A small ("data", "model") mesh over the current group's ranks (a
    one-process group is set up for a 1 x 1 mesh when there is none)."""
    return _grid_mesh((data, model), ("data", "model"), device_type)


def fake_process_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process rank 0): ``DeviceMesh``es of that size can then be built
    and read, and no collective moves data.  For the dry-run, in a process
    of its own; the group stays until ``destroy_process_group``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the dry-run makes its fake group "
                           "in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(world_size))


def make_client_mesh(n_shards: int | None = None, *, axis: str = "clients"):
    """A 1-D client mesh (``DeviceMesh``) named ``axis`` over the ranks of
    the default process group, for ``ShardSpec(mesh=...)``.

    ``n_shards`` defaults to every rank and must equal the group's size.
    With no process group yet, a one-process group is set up: NCCL when a
    card is present, else gloo, through an in-memory store, which needs no
    network.  A mesh over several ranks needs the
    caller's ``torch.distributed.init_process_group`` first, one process a
    card.  The network interface is the caller's to choose
    (``NCCL_SOCKET_IFNAME`` / ``GLOO_SOCKET_IFNAME``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        if n_shards not in (None, 1):
            raise ValueError(
                f"make_client_mesh({n_shards}) spans {n_shards} ranks, but there is no process "
                "group: start one process a card and call torch.distributed."
                "init_process_group first (a one-rank mesh needs none)")
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = world if n_shards is None else int(n_shards)
    if n != world:
        raise ValueError(f"make_client_mesh({n}) over a process group of {world} ranks: a "
                         "client mesh spans every rank (one card a rank)")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def auto_shard_count(num_clients: int, *, n_devices: int | None = None,
                     min_clients_per_shard: int = MIN_CLIENTS_PER_SHARD) -> int:
    """The shard count capped so that every shard holds at least
    ``min_clients_per_shard`` clients: ``num_clients // min_clients_per_shard``
    shards at most, floored at 1, and at most ``n_devices`` (the default
    process group's ranks, 1 without one)."""
    n_dev = n_devices if n_devices is not None else _world()
    return max(1, min(n_dev, num_clients // min_clients_per_shard))


def client_shard_spec(n_shards: int | str | None = None, *, axis: str = "clients",
                      num_clients: int | None = None):
    """A ready ``ShardSpec`` over a fresh client mesh:
    ``FederatedSession(..., shard=client_shard_spec())`` shards the cohort
    over every rank, and ``client_shard_spec("auto", num_clients=M)`` applies
    ``auto_shard_count``."""
    if n_shards == "auto":
        if num_clients is None:
            raise ValueError("client_shard_spec('auto') requires num_clients=")
        n_shards = auto_shard_count(num_clients)
    from repro_torch.fedsim.specs import ShardSpec
    return ShardSpec(mesh=make_client_mesh(n_shards, axis=axis), client_axis=axis)


def device_memory_budget(device="cuda") -> int:
    """Bytes of device memory the streaming engine may spend on one chunk.

    On a CUDA device, a quarter of the card's total memory
    (``torch.cuda.get_device_properties``); the rest stays free for the
    model, the server state, the moments and the client data.  On the CPU,
    which runs only when asked for, a quarter of 4 GiB, the JAX package's
    fallback where a backend reports no limit."""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        limit = torch.cuda.get_device_properties(index).total_memory
    else:
        limit = CPU_FALLBACK_BYTES
    return int(limit * BUDGET_FRACTION)


def auto_chunk_clients(dim: int, client_bytes: int = 0, *, budget_bytes: int | None = None,
                       device="cuda") -> int:
    """The chunk of ``StreamSpec(chunk_clients="auto")``.

    A chunk's peak footprint on the device is about ``chunk * (2 * 4 * dim +
    client_bytes)``: the (c, d) float32 update block, a block of the same
    shape for the LDP noise or PrivUnit's normal (both keyed by client and
    drawn a chunk at a time; clip-only mechanisms leave it as headroom), and
    the chunk's client data.  The chunk is the budget (``budget_bytes``, or
    ``device_memory_budget(device)``) over that cost.  A heuristic with an
    explicit knob, not a guarantee.

    Raises when even one client exceeds the budget: streaming cannot help
    then, and a chunk of 1 would run out of memory one client at a time."""
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    per_client = 2 * 4 * int(dim) + max(0, int(client_bytes))
    budget = budget_bytes if budget_bytes is not None else device_memory_budget(device)
    chunk = budget // per_client
    if chunk < 1:
        raise ValueError(
            f"chunk_clients='auto': one client costs ~{per_client} bytes "
            f"(2 * 4 * dim={dim} update/noise rows + {client_bytes} data "
            f"bytes) but the device budget is {budget} bytes — even "
            "chunk_clients=1 cannot fit.  Shrink the model dimension, shard "
            "clients over more devices, or pass a larger budget_bytes.")
    return int(chunk)
