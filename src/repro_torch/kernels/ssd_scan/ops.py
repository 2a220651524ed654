"""Wrapper of the SSD scan kernels (counterpart of repro/kernels/ssd_scan/ops.py).

The wrapper decides by the tensors' device alone: CPU tensors run the plain
recurrence in ``ref.py``; CUDA tensors launch the hand-written kernels
(``csrc/ssd_scan.cu``: C B^T, chunk states, state passing, chunk outputs) or
raise.  ``ssd_scan.launches`` counts the wrapper's launches of that pipeline;
``chip_smoke.py`` zeroes it before it drives the Mamba2 serve path and reads
it after.

Unlike the JAX wrapper, nothing is padded: the kernels mask a ragged sequence
themselves, and take x's and dt's (batch, step, head) strides and B's and C's
(batch, step) strides, so the model's projections go in as views.  The
kernels' chunk is ``CHUNK`` = 128 steps (128 ran faster than 64 on the H100:
PERF.md).  The JAX wrapper's ``interpret`` is a TPU parameter and has no
counterpart here.  The kernels also return the final state when asked, which
the prefill hands to the decode cache.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

__all__ = ["ssd_scan", "load_library", "CHUNK"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",)
_MAX_STATE = 128
_MAX_GRID = 65535
CHUNK = 128   # the kernels' chunk, in steps (kL in csrc/ssd_scan.cu)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel; declare the C signatures."""
    lib = _build.load_library("ssd_scan", _SOURCES)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssd_scan_scratch_floats.argtypes = [i32] * 5
    lib.ssd_scan_scratch_floats.restype = i64
    lib.ssd_scan_launch.argtypes = [p] * 8 + [i32] * 5 + [i64] * 10 + [p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def _check(x, dt, a, bmat, cmat) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 3:
        raise ValueError(f"want x (B, S, H, P), dt (B, S, H), a (H,) and B, C (B, S, N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bmat.shape)}")
    b, s, h, _ = x.shape
    if dt.shape != (b, s, h) or a.shape != (h,) or bmat.shape[:2] != (b, s) \
            or cmat.shape != bmat.shape:
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if not all(t.is_floating_point() for t in (x, dt, a, bmat, cmat)):
        raise TypeError("x, dt, a, B and C must be floating point")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, *, return_state: bool = False):
    """Chunked SSD scan: y (B, S, H, P) in x's dtype, float32 inside.

    x: (B, S, H, P), dt: (B, S, H) positive steps, a: (H,) negative rates,
    bmat/cmat: (B, S, N).  With ``return_state`` it returns ``(y, state)``, the
    state after the last step as (B, H, N, P) float32.  On CUDA: float32 only,
    N <= 128, and no autograd (the kernels have no backward; the TPU kernel has
    none either).
    """
    _check(x, dt, a, bmat, cmat)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a, bmat, cmat, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, got {x.device}")
    if any(t.device != x.device for t in (dt, a, bmat, cmat)):
        raise ValueError("x, dt, a, B and C must lie on one device")
    if any(t.dtype != torch.float32 for t in (x, dt, a, bmat, cmat)):
        raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}, {dt.dtype}, {a.dtype}, "
                        f"{bmat.dtype}, {cmat.dtype}")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if n > _MAX_STATE or max(b, h, -(-s // CHUNK)) > _MAX_GRID:
        raise ValueError(f"the CUDA kernel takes N <= {_MAX_STATE} and B, H, S / chunk <= "
                         f"{_MAX_GRID}, got N {n}, B {b}, H {h}, S {s}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, bmat, cmat)):
        raise NotImplementedError("the SSD scan kernel has no backward (nor has the TPU "
                                  "kernel); run it under torch.no_grad()")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    # the kernel writes every entry of the state; with no steps it is zero
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device) \
        if return_state else None
    if y.numel() == 0:
        return (y, state.zero_()) if return_state else y
    x, bmat, cmat = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, bmat, cmat))
    a = a.contiguous()
    lib = load_library()
    scratch = torch.empty(lib.ssd_scan_scratch_floats(b, s, h, p, n), dtype=torch.float32,
                          device=x.device)
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        scratch.data_ptr(), y.data_ptr(), None if state is None else state.data_ptr(),
        b, s, h, p, n, *x.stride()[:3], *dt.stride(), *bmat.stride()[:2],
        *cmat.stride()[:2], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
