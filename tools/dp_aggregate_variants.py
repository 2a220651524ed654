#!/usr/bin/env python3
"""What reading the clip threshold C costs the dp_aggregate kernel, on the card.

    python3 tools/dp_aggregate_variants.py [--out FILE]

Builds the committed ``dp_aggregate.cu`` and variants of it, each a textual
edit of that source with the same C interface, and times them in turns at
the main path's shape (M, d) = (1000, 131072) in every mode, with C a float
and (where the variant reads it) C a 0-d tensor on the card: ms per launch,
the median of REPEATS timings of ITERS launches (CUDA events).  Each
variant's outputs are checked against the committed kernel's bits.
Variants:

  kernel        the committed source: C read where a row's scale is taken,
                from the launch's parameters or through the pointer
  float_only    C from the parameters alone (no pointer test, no load: the
                reads of C before the kernel took a pointer)
  at_entry      C read once at entry into a register, then used per row

Needs a CUDA card and nvcc (sm_90a); imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
SRC = ROOT / "src/repro_torch/kernels/dp_aggregate/csrc/dp_aggregate.cu"
M, D = 1000, 131072
ITERS, REPEATS = 50, 5

USE = "clip_of(p) / sqrtf"
ENTRY = "  float sq = 0.0f, clip_sq = 0.0f;\n"   # a line at the kernel's entry


def variants(src: str) -> dict[str, str]:
    """The committed source and its textual variants; fails if an edit no
    longer finds its text."""
    for text in (ENTRY, USE):
        if text not in src:
            raise SystemExit(f"dp_aggregate_variants: the source no longer holds {text!r}")
    return {
        "kernel": src,
        "float_only": src.replace(USE, "p.clip / sqrtf"),
        "at_entry": src.replace(ENTRY, ENTRY + "  const float clip_entry = clip_of(p);\n")
                       .replace(USE, "clip_entry / sqrtf"),
    }


def build(name: str, src: str, tmp: Path) -> tuple[str, str]:
    from repro_torch.kernels import _build
    path = tmp / f"{name}.cu"
    path.write_text(src)
    lib = tmp / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr}")
    return str(lib), proc.stderr


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.dp_aggregate import ops

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dp_aggregate_variants: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    srcs = variants(SRC.read_text())
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(len(srcs) + 1) as pool:
        committed = pool.submit(ops.load_library)   # the wrapper's own build, for its plans
        built = dict(zip(srcs, pool.map(lambda kv: build(*kv, Path(d)), srcs.items())))
        committed.result()
        libs = {}
        for name, (path, ptxas) in built.items():
            lib = ctypes.CDLL(path)
            lib.dp_aggregate_launch.argtypes = ops.load_library().dp_aggregate_launch.argtypes
            lib.dp_aggregate_launch.restype = ctypes.c_int
            libs[name] = lib
            regs = [ln.split("Used")[1].strip() for ln in ptxas.splitlines() if "Used" in ln]
            print(f"{name}: ptxas {regs[:6]}")

        gen = torch.Generator(device=dev).manual_seed(1234)
        u = torch.randn(M, D, generator=gen, device=dev)
        u *= 2 * torch.rand(M, 1, generator=gen, device=dev) / math.sqrt(D)
        noise = 0.5 * torch.randn(M, D, generator=gen, device=dev)
        clip_t = torch.full((), 1.0, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = torch.zeros(16, dtype=torch.int32, device=dev)
        modes = {"none": (0, None, 0.0, 0), "operand": (1, noise, 0.0, 0),
                 "fused": (2, None, 0.7, 7)}

        def launch(lib, mode, clip_at):
            code, nz, sigma, seed = modes[mode]
            plan = ops.launch_plan(M, D, mode, dev)
            scratch = torch.empty(plan.clusters * (D + plan.cluster + 1), device=dev)
            out = torch.empty(D + 2, device=dev)
            err = lib.dp_aggregate_launch(
                u.data_ptr(), None if nz is None else nz.data_ptr(), code, M, D, 1.0,
                clip_at, sigma, seed, 0, None, None, plan.cluster, plan.window, plan.threads,
                plan.pairs, plan.stages, plan.slot_floats, plan.smem_bytes, plan.clusters,
                plan.rows_per_cluster, scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")
            return out

        result = {"card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), "ms": {}}
        cases = [(name, mode, src) for mode in modes for name in libs
                 for src in (("float", "device") if name != "float_only" else ("float",))]
        for name, mode, src in cases:
            clip_at = clip_t.data_ptr() if src == "device" else None
            want = launch(libs["kernel"], mode, None)
            if not torch.equal(launch(libs[name], mode, clip_at), want):
                raise SystemExit(f"{name} {mode} ({src} C): other bits than the kernel's")
        times = {case[:3]: [] for case in cases}
        for _ in range(REPEATS):
            for name, mode, src in cases:
                clip_at = clip_t.data_ptr() if src == "device" else None
                times[(name, mode, src)].append(
                    chip_smoke.cuda_ms(lambda: launch(libs[name], mode, clip_at), ITERS))
        for (name, mode, src), ts in times.items():
            result["ms"][f"{name}/{mode}/{src}"] = statistics.median(ts)
            print(f"{name:10s} {mode:7s} C {src:6s}: {statistics.median(ts):.4f} ms "
                  f"(of {', '.join(f'{t:.4f}' for t in ts)})  [{result['card']}]")
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
