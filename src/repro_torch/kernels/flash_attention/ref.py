"""Plain PyTorch versions of the flash attention kernels (counterpart of
repro/kernels/flash_attention/ref.py).

``attention_ref``: dense softmax attention in float32 on tensors in the
kernels' layout (B, H, S, Dh), with the kernels' masks: causal, sliding
window, and keys at or past ``kv_len``.  The CPU path runs it, the tests hold
it against the JAX package, and ``chip_smoke.py`` holds the CUDA kernels
against it on the card.  ``attention_tc_ref``: the same function in the
tensor-core kernels' rounding order, for the tight check of those kernels
(bf16 with P rounded; float32 with 3xTF32 products); nothing on the model
path calls it.  Both walk the queries in chunks of
``_Q_CHUNK`` rows, so at the serve shape (2, 32, 8192, 8192) they never build
the 17 GB float32 score tensor; each row's softmax is its own, so the
chunking does not change the result.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_tc_ref", "tf32", "einsum_products"]

_Q_CHUNK = 512
_NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, kv_len=None, softcap=None):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh), Hq a multiple of Hkv.

    Query i sees key j when j < kv_len, j <= i (causal) and j > i - window
    (window).  Scores are ``softcap(q.k / sqrt(Dh))``.  A query with no
    visible key gives 0, as the kernel does.  Returns q's dtype.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    k_idx = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, sq, _Q_CHUNK):
        n = min(_Q_CHUNK, sq - i0)
        qc = q[:, :, i0:i0 + n].float().reshape(b, hkv, group, n, dh)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_idx = torch.arange(i0, i0 + n, device=q.device)[:, None]
        mask = k_idx[None, :] < kv_len
        if causal:
            mask = mask & (k_idx <= q_idx)
        if window is not None:
            mask = mask & (k_idx > q_idx - window)
        p = torch.softmax(s.masked_fill(~mask, _NEG_INF), dim=-1) * mask
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        out[:, :, i0:i0 + n] = o.reshape(b, hq, n, dh).to(q.dtype)
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna.tf32.f32 does (the CUDA kernels'
    ``tf32_rna``): to nearest, ties away from zero, the low 13 bits of the
    significand dropped."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def einsum_products(eq: str, a: torch.Tensor, b: torch.Tensor,
                    products: str = "float32") -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of float32 operands with the products a
    kernel makes: ``"float32"``, or ``"3xtf32"`` as the float32 tensor-core
    kernel computes them (each operand split into hi = tf32(x) and lo =
    tf32(x - hi), float32 sums of lo*hi, hi*lo and hi*hi; products of TF32
    values are exact in float32)."""
    if products == "float32":
        return torch.einsum(eq, a, b)
    if products != "3xtf32":
        raise ValueError(f"products must be float32 or 3xtf32, got {products!r}")
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def attention_tc_ref(q, k, v, *, causal=True, window=None, kv_len=None, block_k=128,
                     return_denominator=False, products="float32"):
    """``attention_ref`` in the rounding order of the tensor-core kernel
    (``csrc/flash_attention_tc.cu``), in plain PyTorch.

    Scores are the unscaled q.k of the inputs in float32, then scaled.  The
    keys go by in tiles of ``block_k`` from key 0, with a running row max and
    denominator (online softmax); p is rounded to q's dtype before p.v, and
    the denominator sums the float32 p.  A row that sees no key gives 0.  In
    bfloat16 this is the kernel's order up to the order of float32 sums; with
    float32 inputs and ``block_k=64`` it is the SIMT kernel's, whose p stays
    float32.  ``products="3xtf32"`` at ``ops.f32_block_k(Dh)`` is the float32
    tensor-core kernel's order: both products split into TF32 hi and lo
    (``einsum_products``), p split from its float32 value.
    ``return_denominator`` also returns each row's float32 denominator l (B,
    Hq, Sq), relative to the row's max score: at least 1 where the row sees a
    key, 0 where it sees none.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    denominator = torch.empty(q.shape[:3], device=q.device)
    for i0 in range(0, sq, _Q_CHUNK):
        n = min(_Q_CHUNK, sq - i0)
        qc = q[:, :, i0:i0 + n].float().reshape(b, hkv, group, n, dh)
        q_idx = torch.arange(i0, i0 + n, device=q.device)[:, None]
        m = torch.full((b, hkv, group, n, 1), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, device=q.device)
        lo = max(0, i0 - window + 1) if window else 0     # the band of these rows' keys
        hi = min(kv_len, i0 + n) if causal else kv_len
        for k0 in range(lo - lo % block_k, hi, block_k):
            kt, vt = k[:, :, k0:k0 + block_k].float(), v[:, :, k0:k0 + block_k].float()
            s = einsum_products("bhgqd,bhkd->bhgqk", qc, kt, products) * scale
            k_idx = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            mask = k_idx[None, :] < kv_len
            if causal:
                mask = mask & (k_idx <= q_idx)
            if window is not None:
                mask = mask & (k_idx > q_idx - window)
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            base = m_new.masked_fill(m_new == -math.inf, 0.0)   # no key seen yet: p = 0
            p = torch.exp(s - base)
            alpha = torch.exp(m - base)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + einsum_products("bhgqk,bhkd->bhgqd", p.to(q.dtype).float(), vt,
                                                products)
            m = m_new
        out[:, :, i0:i0 + n] = (acc / l.clamp_min(1e-30)).reshape(b, hq, n, dh).to(q.dtype)
        denominator[:, :, i0:i0 + n] = l.reshape(b, hq, n)
    return (out, denominator) if return_denominator else out
