"""Cost of one step counted from its dispatched operations — the dry-run's
profiler (counterpart of repro/launch/hlo_cost.py).

The JAX package walks the compiled program's HLO text, multiplying a while
body by its trip count.  The port has no compiled program: ``OpCounter``, a
``TorchDispatchMode``, sees every ATen operation a step dispatches (the
backward and the recomputed forward of a checkpointed block included) on
tensors of any device; the dry-run runs steps on the meta device, where
nothing is computed or stored.  It accumulates:

  - flops: products, batched products and convolutions by the formulas of
    ``torch.utils.flop_counter`` (2 m n k for a product, as hlo_cost's 2 x
    result elements x contracted elements); elementwise work is ignored, as
    in hlo_cost (the bytes cover it);
  - bytes: the operands plus the results of every operation that moves data
    (a view, or an ``empty``, moves none; an in-place update counts its
    operand and its result);
  - collective bytes by kind, the result bytes of each collective dispatched
    (``torch.distributed``'s functional collectives);
  - ops: the operations dispatched;
  - the live-tensor high-water mark: the bytes of the storages that the
    step's operations created and that are still referenced, at their
    highest (an estimate of the step's temporary memory: the caching
    allocator's rounding and fragmentation are not modelled).

A stack of identical blocks costs the same for each block, so the dry-run
counts one and two blocks and extends the line to the model's depth
(``extend``), as hlo_cost multiplies a scanned body by its trip count.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry as _FLOPS

__all__ = ["Cost", "OpCounter", "count", "extend", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
_COLLECTIVE_NAMES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("permute", "collective-permute"))
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "detach", "alias", "lift_fresh", "wait_tensor"}


@dataclasses.dataclass
class Cost:
    """What ``OpCounter`` counted (``temp_bytes``: the live high-water mark)."""

    flops: float = 0.0
    bytes: float = 0.0
    ops: float = 0.0
    temp_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})

    def combine(self, other: "Cost", a: float = 1.0, b: float = 1.0) -> "Cost":
        """``a * self + b * other``, field by field."""
        return Cost(a * self.flops + b * other.flops, a * self.bytes + b * other.bytes,
                    a * self.ops + b * other.ops, a * self.temp_bytes + b * other.temp_bytes,
                    {k: a * self.collective_bytes[k] + b * other.collective_bytes[k]
                     for k in COLLECTIVE_KINDS})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_c10d_functional_autograd"):
        return None
    name = func.overloadpacket.__name__
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Counts a region's operations (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live = 0
        self._storages: dict[int, int] = {}

    def _release(self, key: int) -> None:
        self._live -= self._storages.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        self._storages[key] = storage.nbytes()
        self._live += storage.nbytes()
        self.cost.temp_bytes = max(self.cost.temp_bytes, self._live)
        weakref.finalize(storage, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = self.cost
        cost.ops += 1
        packet = func.overloadpacket
        if packet in _FLOPS:
            cost.flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            cost.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
        # a result on an operand's storage (a view, an in-place update) is
        # no new memory; one that moves no data either is a view
        held = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in held]
        free = packet.__name__ in _NO_DATA or (
            outs and not fresh and not func._schema.is_mutable)
        if not free:
            cost.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in fresh:
            self._track(t)
        return out


def count(fn, *args, **kwargs) -> tuple[Cost, object]:
    """(the ``Cost`` of ``fn(*args, **kwargs)``, its result).  The high-water
    mark counts the storages the step's operations made and held at once, its
    outputs included; tensors made before the step (its arguments, a model's
    weights, a cache it updates in place) are not among them."""
    counter = OpCounter()
    with counter:
        result = fn(*args, **kwargs)
    return counter.cost, result


def extend(one: Cost, two: Cost, units: float) -> Cost:
    """The cost at ``units`` identical blocks from the costs at one and at
    two: ``one + (units - 1) * (two - one)``."""
    step = two.combine(one, 1.0, -1.0)
    return one.combine(step, 1.0, float(units - 1))
