"""Roofline terms of a dry-run step on the H100 (counterpart of
repro/launch/roofline.py).

Three terms per (arch x shape x mesh), in seconds per device:

    compute    = FLOPs            / peak FLOP/s
    memory     = bytes accessed   / HBM bandwidth
    collective = collective bytes / link bandwidth

``HW`` holds the constants of one NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3,
700.00 W" as ``nvidia-smi`` names the card the port is measured on), from
NVIDIA's H100 Tensor Core GPU datasheet, H100 SXM column: 989 TFLOP/s of
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450 GB/s a direction
of NVLink (the datasheet's 900 GB/s is both directions together).  No TPU
constant stands here.

The JAX package reads its collective bytes from the compiled, GSPMD-
partitioned program's HLO text.  PyTorch has no such program: the port's
``collective_bytes`` models them from the placements the rules give
(``launch/rules.py``), under the JAX package's result-shape convention (the
bytes of each collective's result on one device; no ring factor):

  - giant models (parameters split on ``embed`` over ``data``): each such
    parameter all-gathered over ``data`` once a forward pass, and in training
    once more for the recomputed forward, its gradient reduce-scattered once;
  - training: the clients' float32 update sums all-reduced over the client
    axes once a round;
  - tensor parallelism over ``model``: an all-reduce of the block's (tokens,
    d_model) activations after each product whose contracted dim is split
    (attention's ``wo``, the MLP's and the shared expert's ``wo``, Mamba2's
    ``ssm_out``), one per routing slot for the MoE's expert combine (experts
    split), and one after the embedding lookup when the vocabulary is split;
    training counts each three times (the forward, its recompute and the
    backward) a local step;
  - serving with a vocabulary split over ``model``: the last position's
    logits all-gathered;
  - a decode step against a sequence-split KV cache (``kv_seq`` over
    ``model``): per attention layer, the partial outputs (b, Hq, Dh) and the
    softmax's max and sum (b, Hq), float32, all-reduced.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "Hardware", "COLLECTIVE_KINDS", "collective_bytes", "roofline_terms",
           "model_flops"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12       # bf16 dense, tensor cores, FLOP/s a card
    hbm_bw: float = 3.35e12          # HBM3, bytes/s a card
    ici_bw: float = 450e9            # NVLink, bytes/s a card and direction


HW = Hardware()


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   hw: Hardware = HW) -> dict[str, float]:
    """Per-device seconds for each roofline term and the dominant one."""
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": bytes_accessed / hw.hbm_bw,
        "collective_s": coll_bytes / hw.ici_bw,
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


def model_flops(num_params: int, active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); D = the step's tokens.

    A decode step's tokens are its batch (one new token a request).  Train
    counts the backward (6 includes forward and backward); serving uses 2 N D."""
    n = active_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def _axes(ax) -> tuple:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def collective_bytes(cfg, kind: str, param_shardings: dict, rules: dict, *, tokens: int,
                     batch: int, tau: int = 1, enc_tokens: int | None = None) -> dict[str, int]:
    """Per-device collective bytes of one step by kind, modelled from the
    placements (the module docstring's list).

    ``param_shardings``: the ``rules.Sharding`` tree of the parameters (the
    JAX package's stacked tree, ``model.pspecs()``); ``tokens``: the tokens
    one device's forward pass carries through the decoder (a client's batch,
    split by the batch rule), ``enc_tokens`` through an enc-dec's encoder,
    ``batch`` its sequences; ``tau`` local steps (training).  Activations are
    bf16, as the dry-run's models are."""
    from repro_torch.models.sharding import AXIS_SIZES_KEY
    sizes = rules[AXIS_SIZES_KEY]
    out = {k: 0 for k in COLLECTIVE_KINDS}
    train = kind == "train"
    passes = 3 * tau if train else 1            # forward, recompute, backward a local step
    model = sizes.get("model", 1)
    itemsize = 2
    sites = cfg.num_layers // cfg.hybrid_attn_every if cfg.arch_type == "hybrid" else 1

    leaves = []   # (name, uses a step, stacked, the stack's tokens, sharding)
    for top, node in param_shardings.items():
        if isinstance(node, dict):
            stacked = top != "shared_attn"
            for name, sh in node.items():
                uses = sh.shape[0] if stacked else sites
                n_tok = enc_tokens if top == "enc_blocks" else tokens
                leaves.append((name, uses, stacked, n_tok, sh))
        else:
            leaves.append((top, 1, False, tokens, node))

    if rules.get("embed") == "data":
        # giant: parameters stored split on embed over data, gathered for use
        for _, _, _, _, sh in leaves:
            if any("data" in _axes(ax) for ax in sh.spec):
                out["all-gather"] += sh.local_bytes * sizes["data"] * (2 * tau if train else 1)
                if train:
                    out["reduce-scatter"] += sh.local_bytes * tau
    if train and rules.get("clients") is not None:
        out["all-reduce"] += sum(4 * sh.local_bytes // sh.itemsize for *_, sh in leaves)

    if model > 1:
        reduced = 0
        for name, uses, stacked, n_tok, sh in leaves:
            first = sh.spec[1] if stacked else sh.spec[0]       # the contracted dim
            if name.endswith(("attn_wo", "mlp_wo", "moe_shared_wo", "ssm_out")) \
                    and "model" in _axes(first):
                reduced += uses * n_tok
            if name == "moe_wo" and "model" in _axes(first):   # (L, E, F, D): experts
                reduced += uses * n_tok * cfg.top_k
        vocab_split = "model" in _axes(param_shardings["embed"].spec[0])
        if vocab_split:
            reduced += tokens
        out["all-reduce"] += passes * reduced * cfg.d_model * itemsize
        if not train and vocab_split:
            out["all-gather"] += batch * cfg.vocab_size * itemsize
    if kind == "decode" and rules.get("kv_seq") == "model" and model > 1:
        attn_layers = sum(uses for name, uses, *_ in leaves if name == "attn_wq")
        if attn_layers:
            hq, dh = cfg.num_heads, cfg.resolved_head_dim
            out["all-reduce"] += attn_layers * 4 * (batch * hq * dh + 2 * batch * hq)
    return out
