#!/usr/bin/env python3
"""Compare two trees of the port on one CUDA card, in one call.

    python3 chip_compare.py OLD_SRC NEW_SRC [NEW_SRC OLD_SRC ...]

Each argument is a directory holding a ``repro_torch`` package (``src`` of a
checkout; an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The trees run one after another, each in a process of
its own, in the order given (old, new, new, old spreads drift over both), and
each measures, with ``chip_smoke.py``'s helpers of this checkout:

  privunit  phase 4's ldp-fedexp-privunit round at M = 1000, d = 131072,
            tau = 20 (``chip_smoke.FULL_SIZE``): ms a round on the host clock
            with the card synchronised, the local/server split of three more
            rounds (CUDA events, medians), the release alone and the noise
            draw plus the release (CUDA events), the round's peak memory;
  ssd       the plain ``ssd_chunked`` and ``_final_state`` at phase 2c's
            serve shape (``chip_smoke.SSD_SERVE``): ms (CUDA events) and the
            peak memory they allocate above their inputs.

Every run prints one JSON line ``{"src": ..., "privunit": {...}, "ssd":
{...}}``; the last lines are the card's name and power limit and one JSON
object with every run.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def privunit(cs, dev) -> dict:
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.data.synthetic import linreg_loss
    from repro_torch.fedsim import cohort_updates
    name = "ldp-fedexp-privunit"
    m, d, tau, rounds = cs.FULL_SIZE
    _, _, data = cs.run_session(name, m, d, 1, tau, dev)             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session, r, data = cs.run_session(name, m, d, rounds, tau, dev, data=data)
    torch.cuda.synchronize()
    round_ms = 1e3 * (time.perf_counter() - t0) / rounds
    cs.check_run(name, r, rounds)
    alg, w = session.algorithm, r.last_w
    state = alg.init_state(w)
    torch.cuda.reset_peak_memory_stats()
    splits = [cs.split_round(session, w, state, rounds + i, None) for i in range(3)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    deltas = cohort_updates(linreg_loss, w, session.client_batches, tau, session.train.eta_l)
    noise = alg.draw_noise(round_generator(3, 0), m, d, dev)
    release_ms = cs.cuda_ms(lambda: alg.mechanism.release(noise, deltas), 5)
    draw_release_ms = cs.cuda_ms(lambda: alg.mechanism.release(
        alg.draw_noise(round_generator(3, 0), m, d, dev), deltas), 5)
    return dict(round_ms=round_ms, local_ms=statistics.median(s[0] for s in splits),
                server_ms=statistics.median(s[1] for s in splits), release_ms=release_ms,
                draw_release_ms=draw_release_ms, peak_gb=peak)


def ssd(cs, dev) -> dict:
    import torch
    from repro_torch.models.ssm import _final_state, ssd_chunked
    args = cs.ssd_inputs(*cs.SSD_SERVE, dev, seed=7)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, state = ssd_chunked(*args), _final_state(*args[:4])
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    finite = bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    del y, state
    ms = cs.cuda_ms(lambda: (ssd_chunked(*args), _final_state(*args[:4])), 2, warmup=1)
    return dict(shape=list(cs.SSD_SERVE), ms=ms, peak_gb=peak, finite=finite)


def one(src: str) -> int:
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(Path(src).resolve()):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = dict(src=src, privunit=privunit(cs, dev), ssd=ssd(cs, dev))
    print(json.dumps(out))
    return 0 if out["ssd"]["finite"] else 1


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 2
    if len(argv) >= 2 and argv[0] == "--one":
        return one(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for src in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", src],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"chip_compare: {src} failed ({proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"runs": runs, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
