"""Plain PyTorch version of the SSD scan kernel (counterpart of
repro/kernels/ssd_scan/ref.py): the step-by-step recurrence.

The CPU path of the wrapper runs it, the tests hold it against the JAX
package, and ``chip_smoke.py`` holds the CUDA kernel against it on the card at
small and ragged shapes.  It walks the sequence one step at a time, so it is
the test oracle and not a fast path.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref"]


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
