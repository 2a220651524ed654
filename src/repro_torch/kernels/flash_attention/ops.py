"""Wrapper of the flash attention kernel (counterpart of repro/kernels/flash_attention/ops.py).

The wrapper decides by the tensors' device alone: CPU tensors run the plain
version in ``ref.py``; CUDA tensors launch the hand-written kernel
(``csrc/flash_attention.cu``) or raise.  ``flash_attention.launches`` counts
the kernel's launches; ``chip_smoke.py`` zeroes it before it drives the serve
path and reads it after.

Unlike the JAX wrapper, nothing is padded: the kernel masks ragged lengths
itself, and takes the tensors' own (batch, head, row) strides, so the
model's (B, S, H, Dh) projections go in as transposed views without a copy.
The kernel's tiles are 64 x 64, chosen for the H100's shared memory; the JAX
wrapper's ``block_q``/``block_k`` are TPU tile sizes that no caller sets, and
have no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention", "load_library"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel; declare the C signature."""
    lib = _build.load_library("flash_attention", _SOURCES)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p] + [i32] * 8 + [ctypes.c_float, i32, i32] + [i64] * 12 + [p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k, v, window, kv_len) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: batch and "
                         "head dim must agree and Hq be a multiple of Hkv")
    if not (q.is_floating_point() and k.dtype == q.dtype and v.dtype == q.dtype):
        raise TypeError(f"q, k, v must share one float dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    skv = k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len must lie in [0, {skv}], got {kv_len}")
    return kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """Blockwise attention; q (B, Hq, Sq, Dh), k/v (B, Hkv, Skv, Dh) -> (B, Hq, Sq, Dh).

    Keys at or past ``kv_len`` (default Skv) are masked.  On CUDA: float32 or
    bfloat16, Dh <= 256, and no autograd (the kernel has no backward).
    """
    kv_len = _check(q, k, v, window, kv_len)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    b, hq, sq, dh = q.shape
    if dh > _MAX_HEAD_DIM or b * hq > _MAX_GRID_Y:
        raise ValueError(f"the CUDA kernel takes Dh <= {_MAX_HEAD_DIM} and B*Hq <= "
                         f"{_MAX_GRID_Y}, got Dh {dh}, B*Hq {b * hq}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash attention kernel has no backward yet "
                                  "(ROADMAP queue 1, item 18); run it under torch.no_grad()")
    if q.numel() == 0:
        return torch.empty_like(q)
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)   # q's layout: a transposed view in, a transposed view out
    err = load_library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, hq, k.shape[1], sq, k.shape[2], dh, kv_len, 1.0 / math.sqrt(dh), int(causal),
        0 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
