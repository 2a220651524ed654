"""Wrapper of the flash attention kernels (counterpart of repro/kernels/flash_attention/ops.py).

The wrapper decides by the tensors' device first: CPU tensors run the plain
version in ``ref.py``; CUDA tensors launch one of three hand-written kernels,
or raise.  Which one is a rule of dtype and head dim alone (``kernel_for``),
and nothing catches a failure of one kernel to try another:

* bfloat16 with Dh <= 256: the tensor-core kernel (``csrc/flash_attention_tc.cu``,
  ``tc_kernel``): TMA loads into a ring of shared-memory stages, ``wgmma`` for
  both products, warp-specialised; key tiles of 128 up to Dh 128 and of 64
  above (``tc_block_k``).  Its TMA maps take 16-byte-aligned base pointers,
  (batch, head, row) strides that are multiples of 8 elements and Dh a
  multiple of 8; a tensor that is not raises ``ValueError``.  It rounds P to
  bf16 before P.V (``ref.attention_tc_ref`` at ``tc_block_k`` has its
  rounding order).
* float32 with Dh <= 256: the float32 tensor-core kernel
  (``csrc/flash_attention_f32.cu``, ``f32_kernel``): both products as 3xTF32
  ``wgmma``, operands split once into shared memory by a producer
  warpgroup; key tiles of 64 up to Dh 128, 32 up to 192 and 16 above
  (``f32_block_k``).  It takes any strides: 16-byte loads where base,
  strides and Dh allow them, else 4-byte ones (``_vec4``).
  ``ref.attention_tc_ref(products="3xtf32")`` at ``f32_block_k`` has its
  rounding order.
* anything else (Dh > 256): the SIMT kernel's rule (``csrc/flash_attention.cu``,
  ``simt_kernel``), which refuses it.  The SIMT kernel (float32 products on
  the CUDA cores, float32 or bfloat16, Dh <= 256) stays callable by name: it
  is the float32 route before the 3xTF32 kernel.

``flash_attention.launches`` counts every launch, ``launches_tc``,
``launches_f32`` and ``launches_simt`` each kernel's, and ``launches_tc_wide``
the tensor-core kernel's launches at Dh > 128 (its 64-key instances);
``chip_smoke.py`` zeroes them before it drives a serve path and reads them
after.

Unlike the JAX wrapper, nothing is padded: the kernels mask ragged lengths
themselves, and take the tensors' own (batch, head, row) strides, so the
model's (B, S, H, Dh) projections go in as transposed views without a copy.
The kernels' tiles are chosen for the H100 (128 queries x 128 or 64 keys on
the bf16 tensor-core path, 64 queries x 64, 32 or 16 keys on the float32 one,
64 x 64 on the SIMT path); the JAX wrapper's ``block_q``/``block_k`` are TPU
tile sizes that no caller sets, and have no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention", "kernel_for", "simt_kernel", "tc_kernel", "f32_kernel",
           "tc_block_k", "f32_block_k", "tma_strides", "load_library", "load_library_tc",
           "load_library_f32"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the SIMT kernel's dtype codes
_MAX_HEAD_DIM = 256          # the SIMT kernel
_TC_MAX_HEAD_DIM = 256       # the tensor-core kernel: up to four 64-wide TMA boxes
_TC_WIDE = 128               # above this head dim, its key tile is 64
_TC_ALIGN = 16               # bytes: TMA's base and stride alignment
_TC_ROWS = 128               # the tensor-core kernel's query tile
_F32_MAX_HEAD_DIM = 256      # the float32 tensor-core kernel: up to eight 32-float boxes
_F32_ROWS = 64               # its query tile
_MAX_GRID_Y = 65535


def _declare(fn, n_ints: int) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, p, p, p] + [i32] * n_ints + [ctypes.c_float, i32, i32] + [i64] * 12 + [p]
    fn.restype = ctypes.c_int


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the SIMT kernel; declare its C signature."""
    lib = _build.load_library("flash_attention", (_CSRC / "flash_attention.cu",))
    _declare(lib.flash_attention_launch, 8)
    return lib


@functools.cache
def load_library_tc() -> ctypes.CDLL:
    """Build (once per source hash) and load the tensor-core kernel; declare its C signature."""
    lib = _build.load_library("flash_attention_tc", (_CSRC / "flash_attention_tc.cu",))
    _declare(lib.flash_attention_tc_launch, 7)
    lib.flash_attention_tc_keys.argtypes = [ctypes.c_int]
    lib.flash_attention_tc_keys.restype = ctypes.c_int
    return lib


@functools.cache
def load_library_f32() -> ctypes.CDLL:
    """Build (once per source hash) and load the float32 tensor-core kernel;
    declare its C signature."""
    lib = _build.load_library("flash_attention_f32", (_CSRC / "flash_attention_f32.cu",))
    _declare(lib.flash_attention_f32_launch, 8)
    lib.flash_attention_f32_keys.argtypes = [ctypes.c_int]
    lib.flash_attention_f32_keys.restype = ctypes.c_int
    return lib


def kernel_for(q: torch.Tensor) -> str:
    """The CUDA kernel that takes ``q``: ``"tc"`` for bfloat16 and ``"f32"``
    for float32, each with Dh <= 256; else ``"simt"``."""
    if q.shape[-1] <= _TC_MAX_HEAD_DIM and q.dtype == torch.bfloat16:
        return "tc"
    if q.shape[-1] <= _F32_MAX_HEAD_DIM and q.dtype == torch.float32:
        return "f32"
    return "simt"


def tc_block_k(dh: int) -> int:
    """The tensor-core kernel's key tile at head dim ``dh``: 128 up to Dh 128,
    64 above, where a 64 x Dh float32 accumulator leaves registers for no
    more (``Smem<DC>::kKeys`` in the source; ``flash_attention_tc_keys``
    returns it from the library).  ``ref.attention_tc_ref`` at this block_k
    is the kernel's rounding order."""
    return 128 if dh <= _TC_WIDE else 64


def f32_block_k(dh: int) -> int:
    """The float32 tensor-core kernel's key tile at head dim ``dh``: 64 up to
    Dh 128, 32 up to 192, 16 above, where shared memory holds Q's, K's and
    V's hi and lo for no more (``Smem<DC>::kKeys`` in the source;
    ``flash_attention_f32_keys`` returns it from the library).
    ``ref.attention_tc_ref(products="3xtf32")`` at this block_k is the
    kernel's rounding order."""
    return 64 if dh <= 128 else 32 if dh <= 192 else 16


def _vec4(*xs: torch.Tensor) -> bool:
    """Whether the float32 kernel may read ``xs`` in 16-byte loads: each base
    16-byte aligned, each stepped (batch, head, row) stride and Dh a multiple
    of 4 elements."""
    return xs[0].shape[-1] % 4 == 0 and all(
        x.data_ptr() % 16 == 0 and all(s % 4 == 0 for n, s in zip(x.shape[:3], x.stride()[:3])
                                       if n > 1) for x in xs)


def tma_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, row) strides of a bf16 (B, H, S, Dh) tensor for a TMA
    map, or ``ValueError``: the base 16-byte aligned, each stride a multiple
    of 8 elements.  A dimension of size 1 is never stepped, so its stride is
    replaced by 8."""
    if x.data_ptr() % _TC_ALIGN:
        raise ValueError(f"the tensor-core flash kernel needs {_TC_ALIGN}-byte-aligned "
                         f"tensors; this one starts at {x.data_ptr():#x}")
    strides = tuple(s if n > 1 else 8 for n, s in zip(x.shape[:3], x.stride()[:3]))
    if any(s % 8 for s in strides) or x.shape[-1] % 8:
        raise ValueError(f"the tensor-core flash kernel needs (batch, head, row) strides and "
                         f"Dh in multiples of 8 elements; got strides {x.stride()} and shape "
                         f"{tuple(x.shape)}")
    return strides


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


def _cuda_inputs(q, k, v, window, kv_len):
    """The checks both kernels share; q, k, v with a contiguous last axis, and kv_len."""
    kv_len = _check(q, k, v, window, kv_len)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the flash kernels take q, k and v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {q.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash attention kernels have no backward (nor has "
                                  "the TPU kernel); run them under torch.no_grad(), and train "
                                  "with attn_impl='xla_flash'")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    return q, k, v, kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """Blockwise attention; q (B, Hq, Sq, Dh), k/v (B, Hkv, Skv, Dh) -> (B, Hq, Sq, Dh).

    Keys at or past ``kv_len`` (default Skv) are masked.  On CUDA, with Dh <=
    256: bfloat16 goes to ``tc_kernel``, float32 to ``f32_kernel``
    (``kernel_for``); no autograd (the kernels have no backward).
    """
    if q.device.type == "cpu":
        kv_len = _check(q, k, v, window, kv_len)
        return ref.attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    launch = {"tc": tc_kernel, "f32": f32_kernel, "simt": simt_kernel}[kernel_for(q)]
    return launch(q, k, v, causal=causal, window=window, kv_len=kv_len)


def simt_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                window: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """The SIMT kernel on CUDA tensors: float32 or bfloat16, Dh <= 256."""
    q, k, v, kv_len = _cuda_inputs(q, k, v, window, kv_len)
    b, hq, sq, dh = q.shape
    if dh > _MAX_HEAD_DIM or b * hq > _MAX_GRID_Y:
        raise ValueError(f"the SIMT flash kernel takes Dh <= {_MAX_HEAD_DIM} and B*Hq <= "
                         f"{_MAX_GRID_Y}, got Dh {dh}, B*Hq {b * hq}")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = torch.empty_like(q)   # q's layout: a transposed view in, a transposed view out
    err = load_library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, hq, k.shape[1], sq, k.shape[2], dh, kv_len, 1.0 / math.sqrt(dh), int(causal),
        0 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention SIMT kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_simt += 1
    return out


def tc_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """The tensor-core kernel on CUDA tensors: bfloat16, Dh a multiple of 8 up
    to 256, TMA-aligned (``tma_strides``)."""
    q, k, v, kv_len = _cuda_inputs(q, k, v, window, kv_len)
    b, hq, sq, dh = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core flash kernel takes bfloat16, got {q.dtype}")
    if dh > _TC_MAX_HEAD_DIM or -(-sq // _TC_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"the tensor-core flash kernel takes Dh <= {_TC_MAX_HEAD_DIM} and "
                         f"Sq <= {_TC_ROWS * _MAX_GRID_Y}, got Dh {dh}, Sq {sq}")
    if q.numel() == 0 or kv_len == 0:   # nothing to load: every row sees no key
        return torch.zeros_like(q)
    out = torch.empty_like(q)   # q's layout: a transposed view in, a transposed view out
    strides = [s for x in (q, k, v) for s in tma_strides(x)]
    err = load_library_tc().flash_attention_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, k.shape[1], sq, k.shape[2], dh, kv_len, 1.0 / math.sqrt(dh), int(causal),
        0 if window is None else int(window), *strides, *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention tensor-core kernel: cuTensorMapEncodeTiled "
                           f"failed (CUresult {-err}; 500: the driver has no such entry point)")
    if err != 0:
        raise RuntimeError(f"flash_attention tensor-core kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_tc += 1
    flash_attention.launches_tc_wide += dh > _TC_WIDE
    return out


def f32_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               window: int | None = None, kv_len: int | None = None) -> torch.Tensor:
    """The float32 tensor-core kernel on CUDA tensors: float32, Dh <= 256,
    any strides."""
    q, k, v, kv_len = _cuda_inputs(q, k, v, window, kv_len)
    b, hq, sq, dh = q.shape
    if q.dtype != torch.float32:
        raise TypeError(f"the float32 tensor-core flash kernel takes float32, got {q.dtype}")
    if dh > _F32_MAX_HEAD_DIM or -(-sq // _F32_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"the float32 tensor-core flash kernel takes Dh <= {_F32_MAX_HEAD_DIM} "
                         f"and Sq <= {_F32_ROWS * _MAX_GRID_Y}, got Dh {dh}, Sq {sq}")
    if q.numel() == 0 or kv_len == 0:   # nothing to load: every row sees no key
        return torch.zeros_like(q)
    out = torch.empty_like(q)   # q's layout: a transposed view in, a transposed view out
    err = load_library_f32().flash_attention_f32_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(_vec4(q, k, v)),
        b, hq, k.shape[1], sq, k.shape[2], dh, kv_len, 1.0 / math.sqrt(dh), int(causal),
        0 if window is None else int(window),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention float32 tensor-core kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.launches_f32 += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_f32 = 0
flash_attention.launches_tc_wide = 0
flash_attention.launches_simt = 0
