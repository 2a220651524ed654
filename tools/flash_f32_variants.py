#!/usr/bin/env python3
"""Where the float32 tensor-core flash kernel's time and error go, on the card.

    python3 tools/flash_f32_variants.py [--out FILE]

Builds the committed ``flash_attention_f32.cu`` and variants of it, each made
by a textual edit of that source, and runs them in turns at the h2o-danube-3-4b
and gemma-2b float32 prefill shapes (chip_smoke.py's phase 2b).  Each variant
prints its registers and spills (ptxas), its ms per launch in two turns (CUDA
events) and its largest error against the 3xTF32 order
(``chip_smoke.f32_reference``) as a share of FLASH_TOL, overall and by query
rows (the rows further down a causal prompt see more keys).  Variants:

  kernel           the committed source
  one_accumulator  P.V accumulated in O itself over the whole row, as the
                   tensor cores' wgmma accumulator, in place of a fresh
                   accumulator per tile added to O in float32
  no_load          the producer stores constants in place of its global loads
  no_split         no operand split: hi = the float32 bits, lo = 0
  no_p_split       only P left unsplit (the consumer's share of the split)
  pv_one_term      P.V as hi*hi alone (two of its three products dropped)

Only ``kernel`` and ``one_accumulator`` compute the function; the others time
a kernel with part of its work removed, so their errors are large by design.
Needs a CUDA card and nvcc (sm_90a); imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention_f32.cu"
SHAPES = {  # (B, Hq, Hkv, S, Dh), window
    "h2o": ((2, 32, 8, 8192, 120), 4096),
    "gemma": ((2, 8, 1, 8176, 256), None),
}
ROWS = ((0, 64), (64, 512), (512, 2048), (2048, 4096), (4096, 8192))

PV_FRESH = """      float pv[kChunk / 2];
      wgmma_fence();"""
PV_IN_O = """      float(&pv)[kChunk / 2] = *reinterpret_cast<float(*)[kChunk / 2]>(acc + h * kChunk / 2);
#pragma unroll
      for (int x = 0; x < kChunk / 2; ++x) pv[x] *= alpha[(x >> 1) & 1];
      wgmma_fence();"""
PV_ADD = """        acc[h * kChunk / 2 + x] = acc[h * kChunk / 2 + x] * alpha[(x >> 1) & 1] + pv[x];"""
PV_FLAG = """                   term + j);"""
PV_TERMS = """      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)"""
LOAD = "x = __ldg(reinterpret_cast<const float4*>(p));"
SPLIT = "  hi = tf32_rna(v);\n  lo = tf32_rna(v - __uint_as_float(hi));"
P_SPLIT_AT = "__device__ __forceinline__ void consume("


def variants(src: str) -> dict[str, str]:
    """The committed source and its textual variants; fails if an edit no
    longer finds its text."""
    for text in (PV_FRESH, PV_ADD, PV_FLAG, PV_TERMS, LOAD, SPLIT, P_SPLIT_AT):
        if text not in src:
            raise SystemExit(f"flash_f32_variants: the source no longer holds {text!r}")
    no_split = "  hi = __float_as_uint(v);\n  lo = 0u;"
    return {
        "kernel": src,
        "one_accumulator": src.replace(PV_FRESH, PV_IN_O).replace(PV_ADD, "        ;")
                              .replace(PV_FLAG, "                   1);"),
        "no_load": src.replace(LOAD, "x = make_float4(row * 1e-3f, c * 1e-3f, 0.5f, 0.25f);"),
        "no_split": src.replace(SPLIT, no_split),
        "no_p_split": src.replace(P_SPLIT_AT, "#define split_tf32(v, h, l) "
                                  "((h) = __float_as_uint(v), (l) = 0u)\n" + P_SPLIT_AT, 1),
        "pv_one_term": src.replace(PV_TERMS, PV_TERMS.replace("term = 0", "term = 2"))
                          .replace(PV_FLAG, "                   term - 2 + j);"),
    }


def build(name: str, source: str, out: Path) -> tuple[str, Path, list[str]]:
    """nvcc with the port's own flags (``_build``) on one variant."""
    from repro_torch.kernels import _build
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(source)
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"flash_f32_variants: nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    report = [line.split("info    : ")[-1].strip() for line in proc.stderr.splitlines()
              if "Used" in line or "spill stores" in line]
    return name, so, report


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, help="also write the results here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        built = list(pool.map(lambda kv: build(*kv, Path(tmp)), variants(SRC.read_text()).items()))
        libs = {}
        for name, so, report in built:
            lib = ctypes.CDLL(str(so))
            ops._declare(lib.flash_attention_f32_launch, 8)
            libs[name] = lib
            print(f"{name}: {'; '.join(report)}")

        def launch(lib, q, k, v, window):
            b, hq, sq, dh = q.shape
            out = torch.empty_like(q)
            err = lib.flash_attention_f32_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, hq, k.shape[1],
                sq, k.shape[2], dh, k.shape[2], 1.0 / math.sqrt(dh), 1,
                0 if window is None else window, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"flash_f32_variants: launch failed, CUDA error {err}")
            return out

        results = {}
        for label, ((b, hq, hkv, s, dh), window) in SHAPES.items():
            g = torch.Generator(device=dev).manual_seed(7)
            q, k, v = (torch.randn(shape, generator=g, device=dev)
                       for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
            want = cs.f32_reference(q, k, v, causal=True, window=window)
            times = {name: [] for name in libs}
            for _ in range(2):   # in turns
                for name, lib in libs.items():
                    times[name].append(cs.cuda_ms(lambda: launch(lib, q, k, v, window), 5))
            for name, lib in libs.items():
                got = launch(lib, q, k, v, window)
                rows = {f"[{a},{min(z, s)})": cs.flash_excess(got[:, :, a:z], want[:, :, a:z])[1]
                        for a, z in ROWS if a < s}
                ratio = cs.flash_excess(got, want)[1]
                results[f"{label}/{name}"] = dict(ms=times[name], tol_share=ratio, by_rows=rows)
                print(f"{label} (B {b}, Hq {hq}, Hkv {hkv}, S {s}, Dh {dh}, window {window}) "
                      f"{name:16s} " + " ".join(f"{t:.4f}" for t in times[name])
                      + f" ms; error {ratio:.3g} of FLASH_TOL against the 3xTF32 order; by rows "
                      + " ".join(f"{r} {x:.3g}" for r, x in rows.items()))
            del q, k, v, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.out:
        args.out.write_text(json.dumps(dict(card=smi, results=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
