"""Mamba2 block (counterpart of repro/models/ssm.py; SSD, arXiv:2405.21060).

Layer structure (single group, as in the JAX package):
    in_proj -> [z | x | B | C | dt]
    causal depthwise conv1d (width 4) over [x | B | C]
    dt = softplus(dt + dt_bias);  A = -exp(A_log)  (per head)
    y = SSD(x, dt, A, B, C) + D * x          (selective state space scan)
    out = out_proj( RMSNorm(y) * silu(z) )

Two execution paths for the SSD scan of a prefill or a training forward,
selected by the attention impl of the model (``attention.IMPLS``):
  - ``kernel``: the hand-written CUDA kernel ``repro_torch.kernels.ssd_scan``
    (its plain recurrence on the CPU), which also returns the final state the
    decode cache needs.  The JAX package names its Pallas kernel as the TPU
    target of this scan; the port runs the kernel here, for serving: it has no
    backward.
  - ``dense``, ``xla_flash`` and ``chunked``: ``ssd_chunked``, the chunked
    path that the JAX package's ``ssm_apply`` always runs, with
    ``_final_state`` for the cache; plain PyTorch, differentiable by autograd.
The decode step is the O(1) state update in plain torch, as in the JAX package.

Types are the JAX package's: the in-projections and the conv in the model's
dtype; the SSD, the D skip, the gated norm and the out-projection in float32
(JAX promotes float32 @ bf16 to a float32 product; torch refuses mixed types,
so the weight is cast); the cache in float32.  Unlike the JAX package, the
cache is updated in place (the returned dict is the one passed in).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.attention import IMPLS
from repro_torch.models.common import Param, rms_norm

__all__ = ["ssm_defs", "ssm_apply", "init_ssm_cache", "ssd_chunked"]


def ssm_defs(cfg: ModelConfig) -> dict[str, Param]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    conv_ch = di + 2 * n
    return {
        "ssm_in_zx": Param((d, 2 * di), ("embed", "ff"), fan_in=d),
        "ssm_in_bcdt": Param((d, 2 * n + h), ("embed", None), fan_in=d),
        "ssm_conv_w": Param((w, conv_ch), (None, None), fan_in=w),
        "ssm_conv_b": Param((conv_ch,), (None,)),
        "ssm_a_log": Param((h,), (None,)),
        "ssm_d_skip": Param((h,), (None,)),
        "ssm_dt_bias": Param((h,), (None,)),
        "ssm_norm": Param((di,), (None,)),
        "ssm_out": Param((di, d), ("ff", "embed"), fan_in=di),
    }


def _chunks(chunk: int, x, dt, bmat, *rest):
    """Pad the sequence to whole chunks with dt = 0 steps (exact no-ops) and
    split it: x (B, nc, c, H, P), dt (B, nc, c, H), the others (B, nc, c, N)."""
    bsz, s, h, p = x.shape
    c = min(chunk, s)
    pad = (-s) % c
    nc = (s + pad) // c
    x = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, c, h, p).float()
    dt = F.pad(dt, (0, 0, 0, pad)).reshape(bsz, nc, c, h).float()
    mats = [F.pad(m, (0, 0, 0, pad)).reshape(bsz, nc, c, -1).float() for m in (bmat, *rest)]
    return x, dt, *mats


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int = 128):
    """Chunked SSD. x: (B,S,H,P), dt: (B,S,H), a: (H,), bmat/cmat: (B,S,N).

    The JAX package's chunk step, for every chunk at once: within a chunk,
    ``((C B^T) * exp(s_i - s_j)) (dt x)`` and the chunk's own state; then the
    states carried across the chunks in order (``h <- exp(s_last) h + S``),
    and each chunk's output from the state entering it.  The same operations
    as the JAX package's scan over chunks, batched over the chunks but for
    the carry, so a training step launches a few dozen kernels a layer and
    not a few hundred."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    xc, dtc, bc, cc = _chunks(chunk, x, dt, bmat, cmat)
    nc, c = xc.shape[1], xc.shape[2]
    idx = torch.arange(c, device=x.device)
    tril = idx[None, :] <= idx[:, None]
    sdec = torch.cumsum(a * dtc, dim=2)                            # (B,nc,c,H)
    xbar = xc * dtc[..., None]
    # mask before the exp: s_i - s_j may overflow it for j > i, and an inf
    # selected away still gives NaN gradients (the JAX package's do, for dt
    # and A); the values are the JAX package's either way
    decay = torch.exp(torch.where(tril[:, :, None],
                                  sdec[:, :, :, None, :] - sdec[:, :, None, :, :], -math.inf))
    scores = torch.einsum("bkln,bkmn->bklm", cc, bc)                # (B,nc,c,c)
    y = torch.einsum("bklmh,bkmhp->bklhp", scores[..., None] * decay, xbar)
    s_last = sdec[:, :, -1, :]                                     # (B,nc,H)
    wdec = torch.exp(s_last[:, :, None, :] - sdec)                 # (B,nc,c,H)
    states = torch.einsum("bkln,bklhp->bkhnp", bc, xbar * wdec[..., None])
    hstate = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(hstate)
        hstate = torch.exp(s_last[:, k])[:, :, None, None] * hstate + states[:, k]
    y = y + torch.exp(sdec)[..., None] * torch.einsum("bkln,bkhnp->bklhp", cc,
                                                      torch.stack(entering, dim=1))
    return y.reshape(bsz, nc * c, h, p)[:, :s].to(x.dtype)


def _final_state(x, dt, a, bmat):
    """State (B, H, N, P) after consuming the full sequence (for prefill -> decode)."""
    bsz, _, h, p = x.shape
    xc, dtc, bc = _chunks(128, x, dt, bmat)
    hstate = torch.zeros(bsz, h, bmat.shape[-1], p, dtype=torch.float32, device=x.device)
    for k in range(xc.shape[1]):
        xk, dtk, bk = xc[:, k], dtc[:, k], bc[:, k]
        sdec = torch.cumsum(a[None, None, :] * dtk, dim=1)
        s_last = sdec[:, -1, :]
        wdec = torch.exp(s_last[:, None, :] - sdec)
        xbar = xk * dtk[..., None]
        hstate = torch.exp(s_last)[:, :, None, None] * hstate + torch.einsum(
            "bln,blhp->bhnp", bk, xbar * wdec[..., None])
    return hstate


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The decode cache, float32 whatever the model's dtype (as in the JAX package)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv_width - 1, di + 2 * n, device=device),
        "state": torch.zeros(batch, cfg.ssm_heads, n, cfg.ssm_head_dim, device=device),
    }


def _causal_conv(h, w, b):
    """Depthwise causal conv1d. h: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    hp = F.pad(h, (0, 0, width - 1, 0))
    out = sum(hp[:, i: i + h.shape[1], :] * w[i] for i in range(width))
    return F.silu(out + b)


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache: dict | None = None,
              impl: str = "kernel"):
    """x: (B, S, D) -> (y, cache). S = 1 with a cache is a decode step; a longer
    S with a cache is a prefill, which fills the cache in place."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; the port has {IMPLS}")
    b, s, _ = x.shape
    di, n, heads, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    width = cfg.ssm_conv_width

    zx = x @ params["ssm_in_zx"]                      # (B,S,2*di)
    z, xin = zx.chunk(2, dim=-1)
    bcdt = x @ params["ssm_in_bcdt"]                  # (B,S,2N+H)
    bmat, cmat, dt_raw = bcdt.split([n, n, heads], dim=-1)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)        # (B,S,di+2N)
    a = -torch.exp(params["ssm_a_log"].float())
    dt = F.softplus(dt_raw.float() + params["ssm_dt_bias"])

    if cache is not None and s == 1:
        hist = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)], dim=1)
        conv_out = _causal_conv(hist, params["ssm_conv_w"], params["ssm_conv_b"])[:, -1:]
        xc, bc, cc = conv_out.split([di, n, n], dim=-1)
        xh = xc.reshape(b, heads, p).float()
        decay = torch.exp(a[None] * dt[:, 0])              # (B,H)
        inject = bc[:, 0][:, None, :, None] * (xh * dt[:, 0][..., None])[:, :, None, :]
        state = decay[:, :, None, None] * cache["state"] + inject
        y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), state)
        y = y + params["ssm_d_skip"][None, :, None] * xh
        y = y.reshape(b, 1, di)
        cache["conv"].copy_(hist[:, 1:])
        cache["state"].copy_(state)
    else:
        conv_out = _causal_conv(conv_in, params["ssm_conv_w"], params["ssm_conv_b"])
        xc, bc, cc = conv_out.split([di, n, n], dim=-1)
        xh = xc.reshape(b, s, heads, p).float()
        args = (xh, dt.reshape(b, s, heads), a, bc.float(), cc.float())
        if impl == "kernel":
            y, state = ssd_scan(*args, return_state=True) if cache is not None \
                else (ssd_scan(*args), None)
        else:
            y = ssd_chunked(*args)
            state = None if cache is None else _final_state(*args[:4])
        y = y + params["ssm_d_skip"][None, None, :, None] * xh
        y = y.reshape(b, s, di)
        if cache is not None:
            # the conv window's last width - 1 inputs; a prefill shorter than
            # that is left-padded with the zeros it was convolved with
            tail = F.pad(conv_in, (0, 0, max(0, width - 1 - s), 0))[:, -(width - 1):]
            cache["conv"].copy_(tail)
            cache["state"].copy_(state)

    y = rms_norm(y, params["ssm_norm"], cfg.norm_eps) * F.silu(z)
    out = (y @ params["ssm_out"].float()).to(x.dtype)
    return out, cache
