"""Attention layer: GQA/MQA/MHA, causal and sliding-window, KV cache, qk-norm
(counterpart of repro/models/attention.py).

Four execution paths for self-attention (``IMPLS``):
  - ``kernel``: the hand-written CUDA flash attention kernel
    (``repro_torch.kernels.flash_attention``; its plain version on the CPU).
    The counterpart of the JAX package's ``pallas`` path, and the default for
    serving.  It has no backward, as the Pallas kernel has none.
  - ``dense``: dense softmax in float32, query chunk by query chunk (the plain
    path).
  - ``xla_flash``: ``blockwise_attention``, online softmax over 512-key blocks
    in plain PyTorch, the JAX package's default and training path.
  - ``chunked``: ``chunked_attention``, a dense softmax per 512-query chunk.
The last three are differentiable by autograd and train through the model.
Cross-attention (``cross_kv``: the enc-dec decoder's K and V of the encoder's
output) takes none of these paths: as in the JAX package it is
``dense_attention`` under ``dense`` or for a one-token step, else
``blockwise_attention``, non-causal, whatever ``impl`` is.

Decode path: single-query attention against a KV cache; sliding-window
layers keep a ring buffer of ``window`` slots.  Unlike the JAX package, the
cache is updated in place (the returned dict is the one passed in), which
saves a copy of every layer's cache per step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import Param, rms_norm, rope, softcap

__all__ = ["attention_defs", "attention_apply", "init_kv_cache", "decode_attention",
           "dense_attention", "blockwise_attention", "chunked_attention", "IMPLS"]

IMPLS = ("kernel", "dense", "xla_flash", "chunked")
_NEG_INF = -1e30


def attention_defs(cfg: ModelConfig, prefix: str = "attn_") -> dict[str, Param]:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    defs = {
        prefix + "wq": Param((d, hq * dh), ("embed", "heads"), fan_in=d),
        prefix + "wk": Param((d, hkv * dh), ("embed", "heads"), fan_in=d),
        prefix + "wv": Param((d, hkv * dh), ("embed", "heads"), fan_in=d),
        prefix + "wo": Param((hq * dh, d), ("heads", "embed"), fan_in=hq * dh),
    }
    if cfg.use_bias:
        defs[prefix + "wq_b"] = Param((hq * dh,), ("heads",))
        defs[prefix + "wv_b"] = Param((hkv * dh,), ("heads",))
        defs[prefix + "wo_b"] = Param((d,), ("embed",))
    if cfg.qk_norm:
        defs[prefix + "qnorm"] = Param((dh,), (None,))
        defs[prefix + "knorm"] = Param((dh,), (None,))
    return defs


def dense_attention(q, k, v, *, causal, window, softcap_val=None):
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh).  The plain path."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap_val)
    return out.transpose(1, 2)


def blockwise_attention(q, k, v, *, causal, window, block_k: int = 512, softcap_val=None):
    """Online-softmax attention over key blocks of ``block_k``; the signature
    of ``dense_attention`` (the JAX package's ``xla_flash`` path).

    The JAX package's arithmetic: K and V padded to whole blocks, q scaled in
    float32 before the products, masked scores set to -1e30 (a fully masked
    block adds weight that the next visible key's rescale wipes, as in the
    JAX package), and the sum of weights floored at 1e-30.  Every block is
    computed, masked or not.  Plain PyTorch, differentiable by autograd.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bk = min(block_k, skv)
    pad = (-skv) % bk
    nk = (skv + pad) // bk
    kb = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(b, nk, bk, hkv, dh).float()
    vb = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, nk, bk, hkv, dh).float()
    qg = (q.float() * (1.0 / math.sqrt(dh))).reshape(b, sq, hkv, group, dh)
    q_idx = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, group, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dh), dtype=torch.float32, device=q.device)
    for ik in range(nk):
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, kb[:, ik]), softcap_val)
        k_idx = ik * bk + torch.arange(bk, device=q.device)[None, :]
        mask = k_idx < skv
        if causal:
            mask = mask & (k_idx <= q_idx)
        if window is not None:
            mask = mask & (k_idx > q_idx - window)
        s = torch.where(mask, s, _NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bhgqk,bkhd->bhgqd", p, vb[:, ik])
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal, window, block_q: int = 512, softcap_val=None):
    """Attention a chunk of ``block_q`` queries at a time, a dense float32
    softmax over all keys in each (the JAX package's ``chunked`` path): q
    padded to whole chunks and scaled before the products, masked scores set
    to -1e30.  Plain PyTorch, differentiable by autograd."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    bq = min(block_q, sq)
    pad = (-sq) % bq
    qp = F.pad(q, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    k_idx = torch.arange(skv, device=q.device)[None, :]
    chunks = []
    for i0 in range(0, sq + pad, bq):
        qg = (qp[:, i0:i0 + bq].float() * scale).reshape(b, bq, hkv, group, dh)
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, kf), softcap_val)
        q_idx = i0 + torch.arange(bq, device=q.device)[:, None]
        mask = torch.ones((bq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_idx <= q_idx)
        if window is not None:
            mask = mask & (k_idx > q_idx - window)
        p = torch.softmax(torch.where(mask, s, _NEG_INF), dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        chunks.append(o.reshape(b, bq, hq, dh).to(q.dtype))
    return torch.cat(chunks, dim=1)[:, :sq]


def decode_attention(q, k_cache, v_cache, cache_positions, pos: int, *, window,
                     softcap_val=None):
    """Single-token attention against a cache.

    q: (B, 1, Hq, dh); caches: (B, Smax, Hkv, dh); cache_positions: (Smax,)
    absolute positions stored in each slot (-1 = empty); pos: current step.
    """
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, dh).float() / math.sqrt(dh)
    s = softcap(torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()), softcap_val)
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        valid = valid & (cache_positions > pos - window)
    p = torch.softmax(s.masked_fill(~valid, _NEG_INF), dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device) -> dict:
    """Cache for ONE attention layer.  Window layers get a ring of ``window`` slots."""
    smax = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    dh, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    return {
        "k": torch.zeros(batch, smax, hkv, dh, dtype=dtype, device=device),
        "v": torch.zeros(batch, smax, hkv, dh, dtype=dtype, device=device),
        "slot_pos": torch.full((smax,), -1, dtype=torch.int32, device=device),
    }


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                    causal: bool = True, cache: dict | None = None, decode_pos: int | None = None,
                    cross_kv=None, impl: str = "kernel", prefix: str = "attn_"):
    """Returns (output, cache).  ``cache`` is updated in place.

    With a cache, a one-token ``x`` is a decode step at ``decode_pos``; a
    longer one is a prefill from position 0.  ``cross_kv``: the (k, v) of
    cross-attention, each (B, Skv, Hkv, Dh); then only q is projected (and
    qk-normed), no RoPE is applied and no cache is read or written.
    """
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    window = cfg.sliding_window

    q = (x @ params[prefix + "wq"]).reshape(b, s, hq, dh)
    if prefix + "wq_b" in params:
        q = q + params[prefix + "wq_b"].reshape(hq, dh)
    if cross_kv is None:
        k = (x @ params[prefix + "wk"]).reshape(b, s, hkv, dh)
        v = (x @ params[prefix + "wv"]).reshape(b, s, hkv, dh)
        if prefix + "wv_b" in params:
            v = v + params[prefix + "wv_b"].reshape(hkv, dh)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(q, params[prefix + "qnorm"], cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, params[prefix + "knorm"], cfg.norm_eps)
    if cfg.use_rope and cross_kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cross_kv is not None:
        attend = dense_attention if impl == "dense" or s == 1 else blockwise_attention
        out = attend(q, k, v, causal=False, window=None)
    elif cache is not None and s == 1:   # decode: write the new KV into its (ring) slot
        slot = int(decode_pos) % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][slot] = int(decode_pos)
        out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"], int(decode_pos),
                               window=window, softcap_val=cfg.attn_logit_softcap)
    else:
        if cache is not None:
            # prefill: window layers keep only the last smax KVs, at their ring
            # slots pos % smax, so later decode writes at pos % smax evict
            # exactly the oldest position
            smax = cache["k"].shape[1]
            keep = min(s, smax)
            pos = torch.arange(s - keep, s, dtype=torch.int32, device=x.device)
            slots = (pos % smax).long()
            cache["k"][:, slots] = k[:, s - keep:].to(cache["k"].dtype)
            cache["v"][:, slots] = v[:, s - keep:].to(cache["v"].dtype)
            cache["slot_pos"][slots] = pos
        out = _self_attention(q, k, v, causal, window, impl, cfg)

    y = out.reshape(b, s, hq * dh) @ params[prefix + "wo"]
    if prefix + "wo_b" in params:
        y = y + params[prefix + "wo_b"]
    return y, cache


def _self_attention(q, k, v, causal, window, impl, cfg: ModelConfig):
    sc = cfg.attn_logit_softcap
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window, softcap_val=sc)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window, softcap_val=sc)
    if impl == "xla_flash":
        return blockwise_attention(q, k, v, causal=causal, window=window, softcap_val=sc)
    if impl == "kernel":
        if sc is not None:
            # the JAX package's pallas path drops the softcap; refuse rather than do that
            raise NotImplementedError("the flash attention kernel has no logit softcap "
                                      "(ROADMAP queue 2, item 3); use attn_impl='dense', "
                                      "'xla_flash' or 'chunked'")
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window)
        return out.transpose(1, 2)
    raise ValueError(f"unknown attention impl {impl!r}; the port has {IMPLS}")
