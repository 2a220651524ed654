"""Plain PyTorch versions of the SSD scan kernels (counterpart of
repro/kernels/ssd_scan/ref.py).

``ssd_scan_ref`` is the step-by-step recurrence: the CPU path of the wrapper
runs it, the tests hold it against the JAX package, and ``chip_smoke.py``
holds the CUDA kernels against it on the card at small and ragged shapes.  It
walks the sequence one step at a time, so it is the test oracle and not a
fast path.

``ssd_scan_stages_ref`` computes the SSD as the CUDA kernels do, stage by
stage at their chunk: C B^T per (batch, chunk), the chunk states, the state
passing over the chunks in order, the chunk outputs.  The tests hold it
against the JAX package and, with the products rounded as the tensor cores
round them, against a float64 recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_scan_ref", "ssd_scan_stages_ref"]


def ssd_scan_ref(x, dt, a, bmat, cmat, *, return_state: bool = False):
    """The recurrence, in float32:

        h_t = exp(a_h dt_t) h_{t-1} + dt_t B_t (x) x_t     (N x P state per head)
        y_t = C_t^T h_t

    x: (B, S, H, P), dt: (B, S, H), a: (H,), bmat/cmat: (B, S, N).  Returns y
    (B, S, H, P) in x's dtype, and with ``return_state`` also the final state
    (B, H, N, P) in float32.
    """
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), bmat.float(), cmat.float()
    af = a.float()
    state = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    ys = torch.empty(bsz, s, h, p, dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])                              # (B, H)
        inject = bf[:, t, None, :, None] * (xf[:, t] * dtf[:, t, :, None])[:, :, None, :]
        state = decay[:, :, None, None] * state + inject
        ys[:, t] = torch.einsum("bn,bhnp->bhp", cf[:, t], state)
    y = ys.to(x.dtype)
    return (y, state) if return_state else y


def ssd_scan_stages_ref(x, dt, a, bmat, cmat, *, chunk: int, return_state: bool = False,
                        matmul=torch.matmul):
    """The SSD in the CUDA kernels' order, in float32, at ``chunk`` steps a
    chunk (s the cumulative log decay inside a chunk, xbar = dt x):

        G       = C B^T                                   per (batch, chunk)
        S_c     = B^T (xbar exp(s_last - s))              per (batch, chunk, head)
        h_in(c) = exp(s_last(c-1)) h_in(c-1) + S_{c-1}    over the chunks in order
        y       = exp(s) (C h_in) + (G . D) xbar,  D_ij = exp(s_i - s_j), j <= i

    The decay scaling is done before the products, as in the kernels.
    ``matmul`` computes every product (the tests pass one that rounds its
    operands as the tensor cores do).  Returns what ``ssd_scan_ref`` returns.
    """
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s   # dt = 0 steps: no-ops that keep s_last the last real step's

    def chunks(t):
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(bmat), chunks(cmat)
    sdec = torch.cumsum(a.float() * dtc, dim=2).transpose(2, 3)      # (B, nc, H, L)
    s_last = sdec[..., -1]                                           # (B, nc, H)
    xt = xc.permute(0, 1, 3, 2, 4)                                   # (B, nc, H, L, P)
    dtt = dtc.transpose(2, 3)[..., None]                             # (B, nc, H, L, 1)
    g = matmul(cc, bc.transpose(-1, -2))                             # (B, nc, L, L)
    xw = xt * (dtt * torch.exp(s_last[..., None] - sdec)[..., None])
    states = matmul(bc.transpose(-1, -2)[:, :, None], xw)            # (B, nc, H, N, P)
    h_in = torch.empty_like(states)
    hcur = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    decay = torch.exp(s_last)
    for c in range(nc):
        h_in[:, c] = hcur
        hcur = decay[:, c, :, None, None] * hcur + states[:, c]
    idx = torch.arange(chunk, device=x.device)
    # select, never multiply by the mask: exp(s_i - s_j) may be inf for j > i
    w = torch.where(idx[None, :] <= idx[:, None],
                    g[:, :, None] * torch.exp(sdec[..., :, None] - sdec[..., None, :]), 0.0)
    y = matmul(cc[:, :, None], h_in) * torch.exp(sdec)[..., None] + matmul(w, xt * dtt)
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * chunk, h, p)[:, :s].to(x.dtype)
    return (y, hcur) if return_state else y
