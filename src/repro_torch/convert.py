"""Parameters of the JAX package -> parameters of the port, and the trainer's
parameters back to the JAX package's layout."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.encdec import NORMS, EncDecLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.tree import tree_map

__all__ = ["params_from_jax", "decoder_from_jax", "encdec_from_jax", "trainer_params_from_jax",
           "trainer_params_to_jax"]

# the leaves of a params tree stacked on a leading L axis: DecoderLM's
# "blocks", EncDecLM's "enc_blocks" and "dec_blocks"
STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _to_tensor(leaf) -> torch.Tensor:
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes supplies it) and torch
        # cannot take it: carry the raw 16 bits across
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device) -> object:
    """Turn ``jax.device_get(params)`` — a tree of numpy arrays (dicts such as
    the README's ``{"W", "b"}``, lists, or one flat (d,) vector) — into the
    same tree of tensors on ``device``.

    Each leaf is copied (``device_get`` may hand out read-only views) and
    keeps its dtype (bfloat16 included) and shape, so ``flatten_model`` of the
    result lists the values in ``ravel_pytree``'s order.
    """
    device = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf).to(device), tree)


def decoder_from_jax(cfg, params, device="cuda"):
    """The port's ``DecoderLM`` holding the JAX package's ``DecoderLM.init``
    parameters (``jax.device_get`` of them).

    The JAX blocks are stacked on a leading L axis (``params["blocks"][name]``
    is (L, ...), an MoE block's experts (L, E, ...)); here they are unstacked
    into one block per layer, by name, for dense (``attn_*``, ``mlp_*``), MoE
    (``moe_*``) and SSM (``ssm_*``) blocks alike.  A hybrid's
    ``params["shared_attn"]`` (not stacked) fills ``model.shared_attn``.  The
    model's dtype is that of the embedding; it takes the kernel path, and a
    caller that wants the plain one sets ``model.attn_impl = "dense"``.
    """
    p = params_from_jax(params, device)
    model = DecoderLM(cfg, dtype=p["embed"].dtype, device=device)
    want = {"embed", "final_norm", "blocks"} | ({"head"} if model.head is not None else set()) \
        | ({"shared_attn"} if model.shared_attn is not None else set())
    if set(p) != want:
        raise ValueError(f"{cfg.name}: parameter names {sorted(p)} differ from {sorted(want)}")
    if set(p["blocks"]) != set(model.blocks[0]):
        raise ValueError(f"{cfg.name}: block parameters {sorted(p['blocks'])} differ from "
                         f"{sorted(model.blocks[0])}")
    if model.shared_attn is not None and set(p["shared_attn"]) != set(model.shared_attn):
        raise ValueError(f"{cfg.name}: shared block parameters {sorted(p['shared_attn'])} "
                         f"differ from {sorted(model.shared_attn)}")
    with torch.no_grad():
        for name in want - {"blocks", "shared_attn"}:
            getattr(model, name).copy_(p[name])
        for name, t in p.get("shared_attn", {}).items():
            model.shared_attn[name].copy_(t)
        for name, stacked in p["blocks"].items():
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"blocks/{name}: {stacked.shape[0]} layers stacked, "
                                 f"{cfg.num_layers} expected")
            for i, block in enumerate(model.blocks):
                block[name].copy_(stacked[i])
    return model


def _fill_blocks(cfg, what: str, blocks, stacked: dict, layers: int) -> None:
    """Copy ``stacked`` ((L, ...) leaves by name) into the per-layer
    ``blocks``, checking the names and the depth."""
    names = set(blocks[0]) if len(blocks) else set(stacked)
    if set(stacked) != names:
        raise ValueError(f"{cfg.name}: {what} parameters {sorted(stacked)} differ from "
                         f"{sorted(names)}")
    for name, leaf in stacked.items():
        if leaf.shape[0] != layers:
            raise ValueError(f"{what}/{name}: {leaf.shape[0]} layers stacked, "
                             f"{layers} expected")
        for i, block in enumerate(blocks):
            block[name].copy_(leaf[i])


def encdec_from_jax(cfg, params, device="cuda"):
    """The port's ``EncDecLM`` holding the JAX package's ``EncDecLM.init``
    parameters (``jax.device_get`` of them).

    ``params["enc_blocks"]`` and ``params["dec_blocks"]``, each stacked on a
    leading L axis, are unstacked into one block per layer, by name; the
    names and both depths are checked.  The model's dtype is that of the
    embedding; it takes the kernel path, and a caller that wants another sets
    ``model.attn_impl``."""
    p = params_from_jax(params, device)
    model = EncDecLM(cfg, dtype=p["embed"].dtype, device=device)
    want = {"embed", "enc_blocks", "dec_blocks", *NORMS}
    if set(p) != want:
        raise ValueError(f"{cfg.name}: parameter names {sorted(p)} differ from {sorted(want)}")
    with torch.no_grad():
        for name in ("embed", *NORMS):
            getattr(model, name).copy_(p[name])
        _fill_blocks(cfg, "enc_blocks", model.enc_blocks, p["enc_blocks"],
                     cfg.num_encoder_layers)
        _fill_blocks(cfg, "dec_blocks", model.dec_blocks, p["dec_blocks"], cfg.num_layers)
    return model


def trainer_params_from_jax(params, device) -> dict:
    """``FederatedTrainer``'s parameter dict, named as ``named_parameters()``
    of a ``DecoderLM`` or an ``EncDecLM``, from the JAX package's params tree
    of the same model (``jax.device_get`` of it): ``blocks[name]``
    (``enc_blocks[name]``, ``dec_blocks[name]``), stacked on L, becomes
    ``"blocks.<i>.<name>"`` (``"enc_blocks.<i>.<name>"``,
    ``"dec_blocks.<i>.<name>"``), a hybrid's ``shared_attn[name]``
    ``"shared_attn.<name>"``; the other leaves keep their names."""
    p = params_from_jax(params, device)
    out = {n: t for n, t in p.items() if n not in (*STACKS, "shared_attn")}
    for stack in STACKS:
        for name, stacked in p.get(stack, {}).items():
            for i in range(stacked.shape[0]):
                out[f"{stack}.{i}.{name}"] = stacked[i].contiguous()
    for name, t in p.get("shared_attn", {}).items():
        out[f"shared_attn.{name}"] = t
    return out


def trainer_params_to_jax(params: dict) -> dict:
    """The JAX package's ``DecoderLM`` or ``EncDecLM`` params tree, numpy
    arrays with the blocks (``enc_blocks``, ``dec_blocks``) stacked on L (and
    a hybrid's ``shared_attn`` dict), of a parameter dict named as
    ``named_parameters()`` (the inverse of ``trainer_params_from_jax``).  A
    dict without encoder or decoder blocks gets ``"blocks"``, empty if it has
    none.  bfloat16 leaves come back as float32: numpy has no bfloat16 of its
    own, the widening is exact, and the JAX package's ``load_checkpoint``
    casts each leaf to its template's dtype."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out, stacks = {}, {}
    for name, t in params.items():
        stack, _, rest = name.partition(".")
        if stack in STACKS and rest:
            i, leaf = rest.split(".", 1)
            stacks.setdefault(stack, {}).setdefault(leaf, {})[int(i)] = host(t)
        elif stack == "shared_attn" and rest:
            out.setdefault("shared_attn", {})[rest] = host(t)
        else:
            out[name] = host(t)
    if not {"enc_blocks", "dec_blocks"} & set(stacks):
        stacks.setdefault("blocks", {})
    for stack, leaves in stacks.items():
        out[stack] = {leaf: np.stack([layers[i] for i in range(len(layers))])
                      for leaf, layers in leaves.items()}
    return out
