"""Mixture-of-Experts block: top-k routing with capacity-bounded dispatch
(counterpart of repro/models/moe.py).

Gather/scatter dispatch: tokens are scattered into capacity-bounded
per-expert buffers (E, C, D), the experts run as two batched products, and
the outputs are gathered back.  The loop over the k routing slots is
unrolled, so peak memory is O(T*D + E*C*D), not O(T*k*D).  Overflowing
tokens are dropped (their combine weight is zero), the standard
capacity-factor semantics; the router's load-balance auxiliary loss keeps
drops rare.

The JAX package groups the tokens into G dispatch groups, G the mesh shards
behind the logical "batch" axis (``repro/models/sharding.py::group_count``),
and without a mesh G is 1.  The port's mesh splits only the client axis of a
federated cohort (``models/sharding.py``), and its grouped dispatch is still
to port (ROADMAP queue 1), hence no ``moe_group_dispatch`` rule: it always
dispatches one group of all B*S tokens, the JAX package's G = 1 path.

Routing order.  ``jax.lax.top_k`` keeps the lower expert index first among
equal probabilities; ``torch.topk`` promises no order on the card, and in a
bf16 model the router's logits are bf16 products, so ties are common.  The
slot order decides the capacity positions and the drops, so ``route`` sorts
the probabilities descending with a stable sort and keeps the first k, as
``core/compression.py::topk_select`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Param
from repro_torch.models.mlp import activation

__all__ = ["moe_defs", "moe_apply", "capacity", "route", "dropped_share"]


def moe_defs(cfg: ModelConfig, prefix: str = "moe_") -> dict[str, Param]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gated = cfg.activation in ("swiglu", "geglu")
    defs = {
        prefix + "router": Param((d, e), ("embed", None), fan_in=d),
        prefix + "wi": Param((e, d, (2 if gated else 1) * f), ("experts", "embed", "ff"),
                             fan_in=d),
        prefix + "wo": Param((e, f, d), ("experts", "ff", "embed"), fan_in=f),
    }
    if cfg.moe_shared_expert:
        defs[prefix + "shared_wi"] = Param((d, (2 if gated else 1) * f), ("embed", "ff"),
                                           fan_in=d)
        defs[prefix + "shared_wo"] = Param((f, d), ("ff", "embed"), fan_in=f)
    return defs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-expert, per-slot capacity of a group of ``tokens``:
    ceil(int(cf * T) / E), floored at 4 so that tiny decode batches stay
    drop-free (``int`` truncates before the ceiling division, as in the JAX
    package)."""
    return int(max(4, -(-int(cfg.capacity_factor * tokens) // cfg.num_experts)))


def route(params, xf: torch.Tensor, cfg: ModelConfig, prefix: str = "moe_"):
    """The router on tokens ``xf`` (T, D): (probs (T, E) float32, gate values
    (T, k) renormalised with a 1e-9 floor, expert ids (T, k) in
    ``lax.top_k``'s order, per slot the capacity position (T, k) of each
    token in its expert's buffer)."""
    logits = (xf @ params[prefix + "router"]).float()
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = ranked.values[:, :cfg.top_k], ranked.indices[:, :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # each slot counts its own positions: a running count over the tokens of
    # each expert, less one, read at the token's own expert.  The one-hot is
    # laid out (k, E, T), so the count is a scan along the innermost axis (a
    # scan along the outer T axis of (T, k, E) took 46% of a granite-moe
    # prefill on the H100)
    ids = gate_idx.T.contiguous()                                   # (k, T)
    experts = torch.arange(cfg.num_experts, device=xf.device)
    counts = torch.cumsum((ids[:, None, :] == experts[None, :, None]).to(torch.int32), dim=-1,
                          dtype=torch.int32)                        # (k, E, T)
    pos = torch.gather(counts, 1, ids[:, None, :])[:, 0].T - 1      # (T, k)
    return probs, gate_vals, gate_idx, pos


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, prefix: str = "moe_"):
    """x: (B, S, D) -> (y, aux_loss), one dispatch group of all B*S tokens.

    Per slot, each token goes to row ``expert * C + position`` of an (E*C + 1,
    D) buffer when its position is below the capacity C, else to the sentinel
    row E*C, which is sliced away; the experts' products run on the (E, C, D)
    buffer and each token gathers its row back, weighted by its gate value
    (0 when dropped).  The combine accumulates in the model dtype for top-1
    and in float32 otherwise, as the JAX package's does; the shared expert
    adds its output last.  ``aux_loss`` is Switch's load-balance loss E *
    sum_e f_e p_e on slot 0's choices (float32).  Gradients reach x, the
    router and the experts: the scatter is an out-of-place ``index_copy``,
    whose indices are unique but for the dropped sentinel.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx, pos = route(params, xf, cfg, prefix)

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux_loss = e * torch.sum(me * ce)

    acc_dtype = x.dtype if k == 1 else torch.float32
    y = torch.zeros((t, d), dtype=acc_dtype, device=x.device)
    sentinel = xf.new_zeros((1, d))
    for slot in range(k):
        keep = pos[:, slot] < cap
        slot_idx = torch.where(keep, gate_idx[:, slot] * cap + pos[:, slot], e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=x.device)
        buf = buf.index_copy(0, slot_idx, xf)[: e * cap].reshape(e, cap, d)
        h = activation(cfg, torch.bmm(buf, params[prefix + "wi"]))
        out = torch.bmm(h, params[prefix + "wo"])                    # (E, C, D)
        out_flat = torch.cat([out.reshape(e * cap, d), sentinel.to(out.dtype)]).to(x.dtype)
        gathered = out_flat.index_select(0, slot_idx)
        weight = (gate_vals[:, slot] * keep).to(acc_dtype)
        y = y + gathered.to(acc_dtype) * weight[:, None]

    if cfg.moe_shared_expert:
        h = activation(cfg, xf @ params[prefix + "shared_wi"])
        y = y + (h @ params[prefix + "shared_wo"]).to(acc_dtype)
    return y.reshape(b, s, d).to(x.dtype), aux_loss


@torch.no_grad()
def dropped_share(params, x: torch.Tensor, cfg: ModelConfig, prefix: str = "moe_") -> float:
    """Share of the (token, slot) assignments of ``x`` (B, S, D) that
    ``moe_apply`` drops for want of capacity (a host read)."""
    t = x.shape[0] * x.shape[1]
    _, _, _, pos = route(params, x.reshape(t, x.shape[-1]), cfg, prefix)
    return float((pos >= capacity(cfg, t)).float().mean())
