"""Parameters of the JAX package -> parameters of the port, and the trainer's
parameters back to the JAX package's layout."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM
from repro_torch.tree import tree_map

__all__ = ["params_from_jax", "decoder_from_jax", "trainer_params_from_jax",
           "trainer_params_to_jax"]


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
    is (L, ...)); here they are unstacked into one block per layer, by name,
    for dense (``attn_*``, ``mlp_*``) and SSM (``ssm_*``) blocks alike.  The
    model's dtype is that of the embedding; it takes the kernel path, and a
    caller that wants the plain one sets ``model.attn_impl = "dense"``.
    """
    p = params_from_jax(params, device)
    model = DecoderLM(cfg, dtype=p["embed"].dtype, device=device)
    want = {"embed", "final_norm", "blocks"} | ({"head"} if model.head is not None else set())
    if set(p) != want:
        raise ValueError(f"{cfg.name}: parameter names {sorted(p)} differ from {sorted(want)}")
    if set(p["blocks"]) != set(model.blocks[0]):
        raise ValueError(f"{cfg.name}: block parameters {sorted(p['blocks'])} differ from "
                         f"{sorted(model.blocks[0])}")
    with torch.no_grad():
        for name in want - {"blocks"}:
            getattr(model, name).copy_(p[name])
        for name, stacked in p["blocks"].items():
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"blocks/{name}: {stacked.shape[0]} layers stacked, "
                                 f"{cfg.num_layers} expected")
            for i, block in enumerate(model.blocks):
                block[name].copy_(stacked[i])
    return model


def trainer_params_from_jax(params, device) -> dict:
    """``FederatedTrainer``'s parameter dict, named as ``DecoderLM``'s
    ``named_parameters()``, from the JAX package's ``DecoderLM`` params tree
    (``jax.device_get`` of it): ``blocks[name]``, stacked on L, becomes
    ``"blocks.<i>.<name>"``; the other leaves keep their names."""
    p = params_from_jax(params, device)
    out = {n: t for n, t in p.items() if n != "blocks"}
    for name, stacked in p["blocks"].items():
        for i in range(stacked.shape[0]):
            out[f"blocks.{i}.{name}"] = stacked[i].contiguous()
    return out


def trainer_params_to_jax(params: dict) -> dict:
    """The JAX package's ``DecoderLM`` params tree, numpy arrays with the
    blocks stacked on L, of a parameter dict named as ``named_parameters()``
    (the inverse of ``trainer_params_from_jax``).  bfloat16 leaves come back
    as float32: numpy has no bfloat16 of its own, the widening is exact, and
    the JAX package's ``load_checkpoint`` casts each leaf to its template's
    dtype."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out, blocks = {}, {}
    for name, t in params.items():
        if name.startswith("blocks."):
            _, i, leaf = name.split(".", 2)
            blocks.setdefault(leaf, {})[int(i)] = host(t)
        else:
            out[name] = host(t)
    out["blocks"] = {leaf: np.stack([layers[i] for i in range(len(layers))])
                     for leaf, layers in blocks.items()}
    return out
