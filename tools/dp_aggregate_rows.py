"""Per-row cost of the dp_aggregate kernel on a CUDA card.

    python tools/dp_aggregate_rows.py          # from the repo root, on the card

For each column width d it launches the kernel's own plan once with a single
cluster (so the card's bandwidth is idle and the time is the cluster's
per-row latency: ring wait, norm exchange, the two passes over the window)
and once with the whole grid, for none and fused mode, at each ring depth
the window allows.  It prints microseconds per row and, for the whole grid,
the rate at which the update matrix streams.  The kernel's output is not
checked here: chip_smoke.py and tests/test_torch_cuda.py do that.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.dp_aggregate import ops

    if not torch.cuda.is_available():
        print("dp_aggregate_rows: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lib = ops.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = ops._tickets_for(torch.device("cuda", torch.cuda.current_device()), stream)

    def launch(u, plan, mode):
        m, d = u.shape
        scratch = torch.empty(plan.clusters * (d + plan.cluster + 1), device=dev)
        out = torch.empty(d + 2, device=dev)
        err = lib.dp_aggregate_launch(
            u.data_ptr(), None, ops._MODES[mode], m, d, 1.0, None, 0.5, 1, 0, None, None,
            plan.cluster, plan.window, plan.threads, plan.pairs, plan.stages, plan.slot_floats,
            plan.smem_bytes, plan.clusters, plan.rows_per_cluster, scratch.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch failed for {plan}: {lib.dp_aggregate_error_name(err)}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    m = 400
    for d in (131072, 16384, 8192, 2048, 500):
        u = 0.01 * torch.randn(m, d, device=dev)
        for mode in ("none", "fused"):
            plan = ops.launch_plan(m, d, mode, dev)
            for stages in sorted({2, plan.stages}):
                one = dataclasses.replace(plan, clusters=1, rows_per_cluster=m, stages=stages,
                                          smem_bytes=4 * plan.slot_floats * stages)
                ms = chip_smoke.cuda_ms(lambda: launch(u, one, mode), 5)
                print(f"d={d} K={plan.cluster} W={plan.window} threads={plan.threads} "
                      f"stages={stages} {mode}: one cluster {1e3 * ms / m:.3f} us/row")
            ms = chip_smoke.cuda_ms(lambda: launch(u, plan, mode), 10)
            print(f"    whole grid, {plan.clusters} clusters: {ms:.4f} ms, "
                  f"{1e3 * ms / m:.3f} us/row, {m * d * 4 / ms / 1e9:.3f} TB/s")
        del u
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
