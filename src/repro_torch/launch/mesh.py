"""Device memory sizing of the streaming engine (counterpart of the sizing
half of repro/launch/mesh.py).

``auto_chunk_clients`` resolves ``StreamSpec(chunk_clients="auto")``: the
largest client chunk whose update block, noise block and staged data fit the
memory budget of ``device_memory_budget``.  The client mesh functions come
with sharded streaming (ROADMAP.md, queue 1, item 16).
"""
from __future__ import annotations

import torch

__all__ = ["device_memory_budget", "auto_chunk_clients"]

BUDGET_FRACTION = 0.25         # of the device's memory, for one chunk
CPU_FALLBACK_BYTES = 4 << 30   # the JAX package's documented host budget


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
