"""Build a kernel's CUDA sources at first use and load them with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles a kernel's
``csrc/*.cu`` into a shared library with a plain C interface.  The library
lands in ``build/`` beside the kernel's ``csrc/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited source never loads a
stale build.  Nothing here runs at import: the CPU path never needs ``nvcc``.
Builds of different kernels may run at once from threads (``subprocess``
releases the interpreter lock).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "build_log"]

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> what its last build printed (ptxas register/spill report)
# and how long it took
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only "
                       "where the CUDA toolkit is installed (set CUDA_HOME)")


def _library_path(name: str, sources: tuple[Path, ...]) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return sources[0].parent.parent / "build" / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str, sources: tuple[Path, ...], target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, *map(str, sources)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log[name] = dict(seconds=time.perf_counter() - t0, ptxas=proc.stderr)


def load_library(name: str, sources: tuple[Path, ...]) -> ctypes.CDLL:
    """Build ``sources`` (once per source hash) into ``lib<name>`` and load it.

    The caller declares the C signatures and caches the result.
    """
    target = _library_path(name, sources)
    if not target.exists():
        _build(name, sources, target)
    else:
        build_log[name] = dict(seconds=0.0, ptxas="(cached build)")
    return ctypes.CDLL(str(target))
