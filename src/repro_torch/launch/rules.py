"""Parameter counting and the physical sharding rules: logical axis names ->
mesh axes, per arch x mode (counterpart of repro/launch/rules.py; DESIGN.md §4).

Two regimes, as in the JAX package:

- **standard** (fits replicated per client): clients enumerate the data axis
  (x the pod axis on two pods); tensor parallelism over the model axis.
- **giant** (>= 20 B parameters: command-r-plus-104b, llama4-maverick-400b,
  chameleon-34b): one client spans the whole (data, model) grid, batch
  parallel over data, tensor parallel over model, and parameter storage also
  split over data on the embed dim (FSDP-style: gathered per layer); the
  cohort axis is the pod axis (two pods) or none (one pod).

``safe_pspec`` drops a mesh axis that does not divide its dimension (vocab
49155 over 16 -> a replicated embedding), so every (arch x shape) pair has a
layout without case work.  A placement spec is plain Python: a tuple with
one entry per dimension, None, a mesh-axis name or a tuple of names (the
JAX package's ``PartitionSpec``).  ``tree_shardings`` gives each leaf that
spec and the matching ``torch.distributed.tensor`` placements (``Shard(dim)``
or ``Replicate()`` per mesh dimension).  Nothing in the port becomes a
DTensor: the dry-run and the input specs read the placements.  Like the JAX
functions, these read only a mesh's axis names and sizes
(``mesh.mesh_dim_names``, ``mesh.shape``), so a ``DeviceMesh`` or any
stand-in with those two attributes will do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.sharding import AXIS_SIZES_KEY, logical_to_pspec
from repro_torch.tree import tree_leaves

__all__ = ["GIANT_PARAM_THRESHOLD", "count_params", "is_giant", "make_rules", "safe_pspec",
           "tree_shardings", "Sharding", "axis_sizes", "placements", "leaf_sharding",
           "tree_local_bytes"]

GIANT_PARAM_THRESHOLD = 20e9


def count_params(model) -> int:
    """Exact parameter count of a ``DecoderLM`` or ``EncDecLM``, or of the
    ``ModelConfig`` it would be built from, as the JAX package's
    ``count_params`` counts it: the embedding, the final norm, every block (an
    MoE block's experts E times), a hybrid's shared block once and an untied
    head; an enc-dec stack's embedding, encoder and decoder blocks and its four
    norms.  A config counts from the defs alone (no tensor is made, so a 104 B
    configuration counts in milliseconds); a model counts its parameters."""
    if not isinstance(model, ModelConfig):
        return sum(p.numel() for p in model.parameters())
    cfg = model

    def size(defs):
        return sum(math.prod(p.shape) for p in defs.values())

    if cfg.arch_type == "audio":
        return (cfg.vocab_size * cfg.d_model + len(encdec.NORMS) * cfg.d_model
                + cfg.num_encoder_layers * size(encdec.enc_block_defs(cfg))
                + cfg.num_layers * size(encdec.dec_block_defs(cfg)))

    shared = size(transformer.shared_attn_defs(cfg)) if cfg.arch_type == "hybrid" else 0
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size
    return (cfg.vocab_size * cfg.d_model + cfg.d_model
            + cfg.num_layers * size(transformer.block_defs(cfg)) + shared + head)


def is_giant(cfg: ModelConfig, num_params: int) -> bool:
    """Whether one client spans the whole device grid (>= 20 B parameters)."""
    return num_params >= GIANT_PARAM_THRESHOLD


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` (or a stand-in)."""
    return dict(zip(tuple(mesh.mesh_dim_names), (int(n) for n in tuple(mesh.shape))))


def make_rules(cfg: ModelConfig, mesh, *, mode: str, num_params: int) -> dict[str, Any]:
    """The rule set of ``cfg`` on ``mesh``; mode: 'train' | 'serve'."""
    names = tuple(mesh.mesh_dim_names)
    has_pod = "pod" in names
    giant = is_giant(cfg, num_params)
    rules: dict[str, Any] = {
        AXIS_SIZES_KEY: axis_sizes(mesh),
        "heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "embed": None,
        "layers": None,
        "seq": None,
    }
    if mode == "train":
        if giant:
            rules["clients"] = "pod" if has_pod else None
            rules["batch"] = "data"
            rules["embed"] = "data"           # FSDP-style parameter storage
            # the JAX package measured a 6x collective regression of the
            # group-local MoE dispatch in giant training (the expert combine's
            # all-reduce over the model axis, under remat and the backward)
            # and no memory gain; serving keeps it
            rules["moe_group_dispatch"] = False
        else:
            rules["clients"] = ("pod", "data") if has_pod else "data"
            rules["batch"] = None
    else:
        rules["clients"] = None
        rules["batch"] = ("pod", "data") if has_pod else "data"
        # the KV cache's sequence dim over the model axis: KV heads rarely
        # divide it (GQA 8 against 16), the 32k/500k sequence always does;
        # the scores are then summed over the model axis
        rules["kv_seq"] = "model"
        if giant:
            rules["embed"] = "data"
    return rules


def safe_pspec(shape: tuple[int, ...], logical: tuple, rules: dict, mesh) -> tuple:
    """Logical names -> a placement spec (one entry per dimension), dropping
    a mesh axis that does not divide its dimension."""
    sizes = axis_sizes(mesh)
    raw = logical_to_pspec(tuple(logical), rules)
    out = []
    for dim, ax in zip(shape, tuple(raw) + (None,) * (len(shape) - len(raw))):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        total = math.prod(sizes[a] for a in axes)
        out.append(ax if dim % total == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's layout on a mesh: its placement ``spec`` (per tensor
    dimension), the ``torch.distributed.tensor`` ``placements`` (per mesh
    dimension: ``Shard(d)`` when the mesh axis splits tensor dim d, else
    ``Replicate()``), the global ``shape`` and ``itemsize``."""

    spec: tuple
    placements: tuple
    shape: tuple
    itemsize: int
    sizes: dict

    @property
    def local_shape(self) -> tuple:
        """The shape each device holds."""
        out = []
        for dim, ax in zip(self.shape, self.spec):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)
            out.append(dim // math.prod(self.sizes[a] for a in axes))
        return tuple(out)

    @property
    def local_bytes(self) -> int:
        """Bytes each device holds."""
        return math.prod(self.local_shape) * self.itemsize


def placements(spec: tuple, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``: per
    mesh dimension, ``Shard(d)`` for the tensor dim d that it splits, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    split = {}
    for d, ax in enumerate(spec):
        for a in () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax):
            split[a] = d
    return tuple(Shard(split[a]) if a in split else Replicate()
                 for a in tuple(mesh.mesh_dim_names))


def leaf_sharding(leaf, logical: tuple, rules: dict, mesh) -> Sharding:
    """The ``Sharding`` of one tensor (a meta tensor will do) with ``logical`` axes."""
    shape = tuple(leaf.shape)
    spec = safe_pspec(shape, logical, rules, mesh)
    return Sharding(spec=spec, placements=placements(spec, mesh), shape=shape,
                    itemsize=leaf.element_size(), sizes=axis_sizes(mesh))


def tree_shardings(mesh, shapes_tree, logical_tree, rules: dict):
    """A ``Sharding`` per leaf of ``shapes_tree`` (tensors, meta tensors will
    do; nested dicts and lists), from the logical axes at the same place of
    ``logical_tree`` (a tuple of names is a leaf there)."""
    def walk(shapes, logical):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], logical[k]) for k in shapes}
        if isinstance(shapes, (list, tuple)):
            return type(shapes)(walk(s, l) for s, l in zip(shapes, logical))
        return leaf_sharding(shapes, logical, rules, mesh)

    return walk(shapes_tree, logical_tree)


def tree_local_bytes(shardings) -> int:
    """The bytes one device holds of a tree of ``Sharding``s."""
    return sum(s.local_bytes for s in tree_leaves(shardings))
