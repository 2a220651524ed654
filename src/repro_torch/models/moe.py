"""Mixture-of-Experts block: top-k routing with capacity-bounded dispatch
(counterpart of repro/models/moe.py).

Gather/scatter dispatch: tokens are scattered into capacity-bounded
per-expert buffers (E, C, D), the experts run as two batched products, and
the outputs are gathered back.  The loop over the k routing slots is
unrolled, so peak memory is O(T*D + E*C*D), not O(T*k*D).  Overflowing
tokens are dropped (their combine weight is zero), the standard
capacity-factor semantics; the router's load-balance auxiliary loss keeps
drops rare.

Dispatch is group-local, as in the JAX package: the B*S tokens are split
batch-major into G groups, G the mesh shards behind the logical "batch" axis
under the installed rules (``models/sharding.py::group_count``), unless the
rules say ``moe_group_dispatch=False`` (giant training).  G falls back to 1
when it does not divide B or a group would hold fewer tokens than experts.
Each group positions its own tokens and has its own capacity per expert and
slot, ``capacity(cfg, B*S / G)``, so a token's fate depends on its group
alone (GShard's local dispatch: on a mesh, the scatter and gather stay on the
token's data shard).  Without rules G is 1: one group of all the tokens.

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
from repro_torch.models.sharding import current_rules, group_count

__all__ = ["moe_defs", "moe_apply", "capacity", "dispatch_groups", "route", "dropped_share"]


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


def dispatch_groups(batch: int, tokens: int, experts: int) -> int:
    """G, the dispatch groups of ``tokens`` tokens from ``batch`` sequences:
    ``group_count("batch")`` under the installed rules (1 without rules, or
    when they set ``moe_group_dispatch=False``), and 1 when G does not divide
    the batch or a group would hold fewer tokens than ``experts``."""
    rules = current_rules() or {}
    g = group_count("batch") if rules.get("moe_group_dispatch", True) else 1
    if g > 1 and (batch % g or tokens // g < experts):
        g = 1
    return g


def route(params, xf: torch.Tensor, cfg: ModelConfig, prefix: str = "moe_", groups: int = 1):
    """The router on tokens ``xf`` (T, D): (probs (T, E) float32, gate values
    (T, k) renormalised with a 1e-9 floor, expert ids (T, k) in
    ``lax.top_k``'s order, per slot the capacity position (T, k) of each
    token in its expert's buffer).  With ``groups`` G, the T tokens are G
    consecutive groups and each counts its positions from 0."""
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
    k, t = cfg.top_k, xf.shape[0]
    ids = gate_idx.T.reshape(k, groups, t // groups)                # (k, G, Tg)
    experts = torch.arange(cfg.num_experts, device=xf.device)
    counts = torch.cumsum((ids[:, None] == experts[None, :, None, None]).to(torch.int32),
                          dim=-1, dtype=torch.int32)                # (k, E, G, Tg)
    pos = torch.gather(counts, 1, ids[:, None])[:, 0].reshape(k, t).T - 1   # (T, k)
    return probs, gate_vals, gate_idx, pos


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, prefix: str = "moe_"):
    """x: (B, S, D) -> (y, aux_loss), in G dispatch groups (``dispatch_groups``).

    Per slot, a token of group j goes to row ``(expert * G + j) * C +
    position`` of an (E*G*C + 1, D) buffer when its position is below the
    capacity C, else to the sentinel row E*G*C, which is sliced away; the
    experts' products run on the (E, G*C, D) buffer and each token gathers
    its row back, weighted by its gate value (0 when dropped).  The combine
    accumulates in the model dtype for top-1 and in float32 otherwise, as the
    JAX package's does; the shared expert adds its output last.  ``aux_loss`` is Switch's
    load-balance loss E * sum_e f_e p_e on slot 0's choices over all tokens
    (float32).  Gradients reach x, the router and the experts: the scatter is
    an out-of-place ``index_copy``, whose indices are unique but for the
    dropped sentinel.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    g = dispatch_groups(b, t, e)
    tg = t // g
    cap = capacity(cfg, tg)
    xf = x.reshape(t, d)
    probs, gate_vals, gate_idx, pos = route(params, xf, cfg, prefix, groups=g)

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux_loss = e * torch.sum(me * ce)

    acc_dtype = x.dtype if k == 1 else torch.float32
    y = torch.zeros((t, d), dtype=acc_dtype, device=x.device)
    # expert-major rows: expert e's buffer holds its C rows of group 0, then
    # group 1's, ...; the sentinel is the last row.  The products then run on
    # (E, G*C, D) with no copy between the layouts (G = 1: the plain rows)
    group_rows = None if g == 1 else (torch.arange(t, device=x.device) // tg) * cap
    sentinel = xf.new_zeros((1, d))
    for slot in range(k):
        keep = pos[:, slot] < cap
        row = gate_idx[:, slot] * (g * cap) + pos[:, slot]
        if group_rows is not None:
            row = row + group_rows
        slot_idx = torch.where(keep, row, e * g * cap)
        buf = torch.zeros((e * g * cap + 1, d), dtype=xf.dtype, device=x.device)
        buf = buf.index_copy(0, slot_idx, xf)[: e * g * cap].reshape(e, g * cap, d)
        h = activation(cfg, torch.bmm(buf, params[prefix + "wi"]))
        out = torch.bmm(h, params[prefix + "wo"])                    # (E, G*C, D)
        out_flat = torch.cat([out.reshape(e * g * cap, d), sentinel.to(out.dtype)]).to(x.dtype)
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
    g = dispatch_groups(x.shape[0], t, cfg.num_experts)
    _, _, _, pos = route(params, x.reshape(t, x.shape[-1]), cfg, prefix, groups=g)
    return float((pos >= capacity(cfg, t // g)).float().mean())
