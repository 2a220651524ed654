"""Logical-axis rules (counterpart of repro/models/sharding.py).

Model and engine code name the axes of a tensor by *logical* names
(``"clients"``, ``"batch"``, ``"heads"``, ...); a rule set maps each name to
the mesh axes it splits over.  A placement is plain Python: a tuple with one
entry per tensor dimension, None (not split), a mesh-axis name, or a tuple
of names.  With no rules installed every annotation is the identity.

These are the JAX module's names.  The launch layer's rules
(``launch/rules.py::make_rules``) give the datacenter layout of every
parameter and input; under installed rules the MoE block reads
``group_count("batch")``, its dispatch groups (1 without rules).  The port
splits only the client axis over real ranks, over a ``torch.distributed``
client mesh (``fedsim.specs.ShardSpec``), and always along a client batch's
leading dimension (``fedsim.server.local_cohort``).  ``shard`` returns a
tensor unchanged: a plain tensor carries no placement, and no model code of
the port runs over a mesh.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["AXIS_SIZES_KEY", "axis_rules", "current_rules", "client_axis_rules",
           "logical_to_pspec", "group_count", "shard"]

_STATE = threading.local()

AXIS_SIZES_KEY = "__axis_sizes__"   # the mesh axes' sizes, beside the rules


def current_rules() -> dict | None:
    """The installed rule set, or None."""
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: dict):
    """Install logical -> mesh axis rules for the enclosed region."""
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def client_axis_rules(mesh, *, axis: str = "clients") -> dict:
    """The rule set that maps the logical ``clients`` axis onto a client mesh
    (a ``DeviceMesh``, or anything with ``mesh_dim_names`` and ``shape``),
    with the mesh's axis sizes under ``AXIS_SIZES_KEY``."""
    return {"clients": axis,
            AXIS_SIZES_KEY: dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))}


def logical_to_pspec(names: tuple, rules: dict | None = None,
                     dims: tuple[int, ...] | None = None) -> tuple:
    """The placement of a tensor whose dimensions carry the logical ``names``:
    one entry per dimension, None, a mesh-axis name or a tuple of names.

    A mesh axis appears at most once.  With ``dims`` and the rules' axis
    sizes, a mesh axis that does not divide its dimension is dropped, as in
    the JAX package."""
    rules = rules if rules is not None else (current_rules() or {})
    sizes = rules.get(AXIS_SIZES_KEY)
    axes = []
    used: set[str] = set()
    for i, n in enumerate(names):
        ax = rules.get(n) if n is not None else None
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat if a not in used)
            if flat and sizes is not None and dims is not None:
                total = 1
                for a in flat:
                    total *= sizes.get(a, 1)
                if dims[i] % total != 0:
                    flat = ()
            used.update(flat)
            ax = None if not flat else (flat[0] if len(flat) == 1 else flat)
        axes.append(ax)
    return tuple(axes)


def group_count(logical_name: str) -> int:
    """The number of mesh shards behind a logical axis under the installed
    rules (1 without rules)."""
    rules = current_rules()
    if not rules:
        return 1
    sizes = rules.get(AXIS_SIZES_KEY)
    ax = rules.get(logical_name)
    if ax is None or sizes is None:
        return 1
    g = 1
    for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
        g *= sizes.get(a, 1)
    return g


def shard(x, *names):
    """``x`` annotated with logical axis names: returned unchanged (a plain
    tensor carries no placement).  The names must match its rank."""
    if current_rules() is not None and len(names) != x.dim():
        raise ValueError(f"{len(names)} logical names {names} for a {x.dim()}-d tensor")
    return x
