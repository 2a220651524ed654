"""Attention layer: GQA/MQA/MHA, causal and sliding-window, KV cache, qk-norm
(counterpart of repro/models/attention.py).

Two execution paths for self-attention:
  - ``kernel``: the hand-written CUDA flash attention kernel
    (``repro_torch.kernels.flash_attention``; its plain version on the CPU).
    The counterpart of the JAX package's ``pallas`` path, and the default.
  - ``dense``: dense softmax in float32, query chunk by query chunk (the plain
    path).
The JAX package's ``xla_flash`` and ``chunked`` paths, and cross-attention
(``cross_kv``, enc-dec), are still to port (ROADMAP.md).

Decode path: single-query attention against a KV cache; sliding-window
layers keep a ring buffer of ``window`` slots.  Unlike the JAX package, the
cache is updated in place (the returned dict is the one passed in), which
saves a copy of every layer's cache per step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import Param, rms_norm, rope, softcap

__all__ = ["attention_defs", "attention_apply", "init_kv_cache", "decode_attention",
           "dense_attention", "IMPLS"]

IMPLS = ("kernel", "dense")
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
    longer one is a prefill from position 0.
    """
    if cross_kv is not None:
        raise NotImplementedError("cross-attention (enc-dec) is not ported yet "
                                  "(ROADMAP queue 1, item 17)")
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    window = cfg.sliding_window

    q = (x @ params[prefix + "wq"]).reshape(b, s, hq, dh)
    if prefix + "wq_b" in params:
        q = q + params[prefix + "wq_b"].reshape(hq, dh)
    k = (x @ params[prefix + "wk"]).reshape(b, s, hkv, dh)
    v = (x @ params[prefix + "wv"]).reshape(b, s, hkv, dh)
    if prefix + "wv_b" in params:
        v = v + params[prefix + "wv_b"].reshape(hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params[prefix + "qnorm"], cfg.norm_eps)
        k = rms_norm(k, params[prefix + "knorm"], cfg.norm_eps)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is not None and s == 1:   # decode: write the new KV into its (ring) slot
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
    if impl == "kernel":
        if sc is not None:
            # the JAX package's pallas path drops the softcap; refuse rather than do that
            raise NotImplementedError("the flash attention kernel has no logit softcap "
                                      "(ROADMAP queue 2, item 3); use attn_impl='dense'")
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window)
        return out.transpose(1, 2)
    raise NotImplementedError(f"attention impl {impl!r} is not ported; the port has "
                              f"{IMPLS} (xla_flash and chunked: ROADMAP queue 1, item 17)")
