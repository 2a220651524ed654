"""Input specs and their layouts for every (arch x shape) (counterpart of
repro/launch/specs.py).

The dry-run traces against these stand-ins: meta-device tensors (shape and
dtype, no storage) in place of the JAX package's ``ShapeDtypeStruct``.  For
the stubbed frontends (audio, VLM) the specs carry precomputed frame
embeddings or VQ token ids, as in the JAX package.

The port's caches are per layer (``DecoderLM.init_cache``: {"blocks": [one
dict a layer]}; a hybrid's {"ssm": [...], "attn": [...]}), the JAX
package's stacked on a leading layers axis; ``cache_logical`` keys on the
same leaf names and gives a per-layer leaf the JAX leaf's axes without
"layers".
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import FederatedConfig, ModelConfig, ShapeConfig
from repro_torch.launch.rules import tree_shardings

__all__ = ["cohort_size", "train_input_specs", "decode_input_specs", "prefill_input_specs",
           "cache_logical", "tree_input_shardings", "WHISPER_DECODER_LEN",
           "WHISPER_ENC_FRAMES"]

WHISPER_DECODER_LEN = 256    # decoder tokens per utterance in train/prefill
WHISPER_ENC_FRAMES = 1500    # whisper's fixed 30 s encoder length (decode mode)

_META = torch.device("meta")


def cohort_size(mesh, rules: dict) -> int:
    """The clients of one round: the mesh shards behind the "clients" rule (1 without one)."""
    ax = rules.get("clients")
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    sizes = dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))
    return math.prod(int(sizes[a]) for a in axes)


def _leaf_logical(name: str, nd: int) -> tuple:
    """The logical axes of a cache leaf named ``name`` of rank ``nd``.

    "kv_seq" (not "seq"): the KV cache splits its sequence dim over the model
    axis in serving, since KV heads rarely divide it (GQA 8 against 16) and
    the 32k/500k sequence always does.  A stacked leaf (the JAX package's)
    leads with "layers"."""
    if name in ("k", "v"):
        return ("layers", "batch", "kv_seq", "heads", None)[:nd] if nd == 5 \
            else ("batch", "kv_seq", "heads", None)[:nd]
    if name == "slot_pos":
        return ("layers", "kv_seq")[:nd] if nd == 2 else ("kv_seq",)
    if name == "conv":
        return ("layers", "batch", None, "ff")[:nd] if nd == 4 else ("batch", None, "ff")
    if name == "state":
        return ("layers", "batch", "ff", None, None)[:nd] if nd == 5 \
            else ("batch", "ff", None, None)
    return (None,) * nd


def cache_logical(cache_shapes) -> Any:
    """Logical axes for a KV/SSM cache tree (dicts and lists of tensors),
    keyed on each leaf's dict key and rank."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, "") for v in node)
        return _leaf_logical(name, node.dim())

    return walk(cache_shapes, "")


def tree_input_shardings(mesh, shapes, logical, rules):
    """A ``rules.Sharding`` per input leaf (``rules.tree_shardings``)."""
    return tree_shardings(mesh, shapes, logical, rules)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, fed: FederatedConfig, mesh,
                      rules: dict):
    """(shapes dict, logical dict) of a round's batch, laid out (K, tau, b, S)."""
    k = cohort_size(mesh, rules)
    if shape.global_batch % k:
        raise ValueError(f"global batch {shape.global_batch} does not split over {k} clients")
    b = shape.global_batch // k
    tau = fed.local_steps
    s = shape.seq_len
    logical_tok = ("clients", None, "batch", None)
    tok = _spec((k, tau, b, s), torch.int32)
    shapes = {"tokens": tok, "labels": tok}
    logical = {"tokens": logical_tok, "labels": logical_tok}
    if cfg.arch_type == "audio":
        # stub frontend: precomputed frame embeddings for the encoder; the
        # decoder reads WHISPER_DECODER_LEN text tokens per utterance
        shapes["frames"] = _spec((k, tau, b, s, cfg.d_model), torch.bfloat16)
        logical["frames"] = ("clients", None, "batch", "seq", None)
        dec = _spec((k, tau, b, WHISPER_DECODER_LEN), torch.int32)
        shapes["tokens"] = dec
        shapes["labels"] = dec
    return shapes, logical


def _meta_cache(model, batch: int, seq_len: int):
    """``model``'s cache (a model built on the meta device: no storage)."""
    if model.device.type != "meta":
        raise ValueError("the input specs read a model built on the meta device "
                         "(build_model(..., device='meta'))")
    return model.init_cache(batch, seq_len)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict, model):
    """ONE new token against a cache of ``shape.seq_len`` (the decode step)."""
    b, s = shape.global_batch, shape.seq_len
    caches = _meta_cache(model, b, s)
    shapes = {"token": _spec((b,), torch.int32), "pos": _spec((), torch.int32),
              "caches": caches}
    logical = {"token": ("batch",), "pos": (), "caches": cache_logical(caches)}
    if cfg.arch_type == "audio":
        shapes["enc_out"] = _spec((b, WHISPER_ENC_FRAMES, cfg.d_model), torch.bfloat16)
        logical["enc_out"] = ("batch", "seq", None)
    return shapes, logical


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict, model):
    """The prompt (an enc-dec's frames and decoder tokens) and the cache it fills."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.arch_type == "audio":
        caches = _meta_cache(model, b, WHISPER_DECODER_LEN)
        shapes = {"frames": _spec((b, s, cfg.d_model), torch.bfloat16),
                  "tokens": _spec((b, WHISPER_DECODER_LEN), torch.int32), "caches": caches}
        logical = {"frames": ("batch", "seq", None), "tokens": ("batch", None),
                   "caches": cache_logical(caches)}
        return shapes, logical
    caches = _meta_cache(model, b, s)
    shapes = {"tokens": _spec((b, s), torch.int32), "caches": caches}
    logical = {"tokens": ("batch", None), "caches": cache_logical(caches)}
    return shapes, logical
