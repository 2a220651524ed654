"""Plain PyTorch version of the flash attention kernel (counterpart of
repro/kernels/flash_attention/ref.py).

Dense softmax attention in float32 on tensors in the kernel's layout
(B, H, S, Dh), with the kernel's masks: causal, sliding window, and keys at or
past ``kv_len``.  The CPU path runs it, the tests hold it against the JAX
package, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
It walks the queries in chunks of ``_Q_CHUNK`` rows, so at the serve shape
(2, 32, 8192, 8192) it never builds the 17 GB float32 score tensor; each row's
softmax is its own, so the chunking does not change the result.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]

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
