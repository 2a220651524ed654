"""Build the dp_aggregate CUDA kernels at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles ``csrc/*.cu`` into a
shared library with a plain C interface.  The library lands in ``build/``
beside this file (listed in ``.gitignore``), named by a hash of the sources
and flags, so an edited source never loads a stale build.  Nothing here runs
at import: the CPU path never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "build_log"]

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "csrc" / "dp_aggregate.cu",)
_BUILD_DIR = _HERE / "build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build printed (ptxas register/spill report) and how long it took
build_log: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the dp_aggregate CUDA kernels build only "
                       "where the CUDA toolkit is installed (set CUDA_HOME)")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libdp_aggregate-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, *map(str, _SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels; declare the C signatures."""
    target = _library_path()
    if not target.exists():
        _build(target)
    else:
        build_log.update(seconds=0.0, ptxas="(cached build)")
    lib = ctypes.CDLL(str(target))
    p, i64, f32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint32
    lib.dp_aggregate_launch.argtypes = [
        p, p, ctypes.c_int, i64, i64, f32, f32, u32, i64, i64, ctypes.c_int,
        p, p, p, p, p, p, p, p]
    lib.dp_aggregate_launch.restype = ctypes.c_int
    lib.ldp_noise_launch.argtypes = [p, i64, i64, f32, u32, i64, p]
    lib.ldp_noise_launch.restype = ctypes.c_int
    return lib
