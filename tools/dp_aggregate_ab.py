"""Time the dp_aggregate kernel and the full-size round of the tree this file lies in.

    python tools/dp_aggregate_ab.py          # from a tree's root, on the card

To compare two commits on one card, copy this file into a second tree
(``git archive`` of the other commit) and run the two in turns, e.g. A, B, B,
A.  Each run prints one JSON line: the card, the kernel's ms per launch at
(M, d) = (1000, 131072) in every mode with C a float (and with C a 0-d
tensor on the card where the tree's wrapper takes one; interleaved with the
float-C launch) and a digest of each mode's output bits (equal digests: the
same bits in both trees), the median of REPEATS timings of ITERS launches each
(CUDA events), and ms per round of ldp-fedexp-gauss and cdp-fedexp at M =
1000, d = 131072, tau = 20 (host clock over ROUNDS rounds, card
synchronised, after a one-round warm-up), the median of REPEATS runs.
Where the tree's wrapper takes a row gate, it also times the gated kernel in
every mode with ~10% of the rows on ("<mode>/gated") and a gathered block of
CohortSpec(q=0.1) at (176, 131072) with row ids ("<mode>/gathered").
"""
from __future__ import annotations

import hashlib
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

M, D, TAU, ROUNDS = 1000, 131072, 20, 5
ITERS, REPEATS = 50, 5


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.dp_aggregate import ops

    if not torch.cuda.is_available():
        print("dp_aggregate_ab: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    u = torch.randn(M, D, generator=gen, device=dev)
    u *= 2 * torch.rand(M, 1, generator=gen, device=dev) / math.sqrt(D)
    noise = 0.5 * torch.randn(M, D, generator=gen, device=dev)
    clip_t = torch.full((), 1.0, device=dev)
    device_clip = hasattr(ops, "_clip_arg")   # the wrapper takes C as a tensor
    out = {"tree": str(ROOT), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "kernel_ms": {}, "round_ms": {}}
    for mode, kw in (("none", {}), ("operand", {"noise": noise}),
                     ("fused", {"noise_seed": 7, "noise_sigma": 0.7})):
        clips = (("float", 1.0), ("device", clip_t)) if device_clip else (("float", 1.0),)
        times = {name: [] for name, _ in clips}
        for _ in range(REPEATS):
            for name, clip in clips:
                times[name].append(chip_smoke.cuda_ms(
                    lambda: ops.dp_aggregate_sums(u, clip, **kw), ITERS))
        for name, ts in times.items():
            out["kernel_ms"][f"{mode}/{name}"] = statistics.median(ts)
        sums = torch.cat([x.reshape(-1) for x in ops.dp_aggregate_sums(u, 1.0, **kw)])
        out.setdefault("bits", {})[mode] = hashlib.sha256(
            sums.cpu().numpy().tobytes()).hexdigest()[:16]
    if "row_gate" in inspect.signature(ops.dp_aggregate_sums).parameters:
        g = torch.Generator().manual_seed(5)
        gate = (torch.rand(M, generator=g) < 0.1).to(torch.float32)
        slots = torch.sort(torch.nonzero(gate).flatten()).values
        cap = 176                                # CohortSpec(q=0.1).resolved_cap(1000)
        slots = torch.cat([slots[:cap], torch.zeros(cap - min(cap, slots.numel()),
                                                    dtype=torch.int64)]).to(dev)
        slot_gate = torch.zeros(cap)
        slot_gate[:int(gate.sum())] = 1.0
        gate, slot_gate = gate.to(dev), slot_gate.to(dev)
        ub, nb = u[slots], noise[slots]
        for mode, kw, bkw in (
                ("none", {}, {}), ("operand", {"noise": noise}, {"noise": nb}),
                ("fused", {"noise_seed": 7, "noise_sigma": 0.7},
                 {"noise_seed": 7, "noise_sigma": 0.7, "row_ids": slots})):
            times = {"gated": [], "gathered": []}
            for _ in range(REPEATS):
                times["gated"].append(chip_smoke.cuda_ms(
                    lambda: ops.dp_aggregate_sums(u, 1.0, row_gate=gate, **kw), ITERS))
                times["gathered"].append(chip_smoke.cuda_ms(
                    lambda: ops.dp_aggregate_sums(ub, 1.0, row_gate=slot_gate, **bkw), ITERS))
            for name, ts in times.items():
                out["kernel_ms"][f"{mode}/{name}"] = statistics.median(ts)
        del ub, nb
    del u, noise
    torch.cuda.empty_cache()
    data = None
    for name in ("ldp-fedexp-gauss", "cdp-fedexp"):
        _, _, data = chip_smoke.run_session(name, M, D, 1, TAU, dev, data=data)
        runs = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chip_smoke.run_session(name, M, D, ROUNDS, TAU, dev, data=data)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / ROUNDS)
        out["round_ms"][name] = statistics.median(runs)
        out["round_ms"][name + "/runs"] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
