#!/usr/bin/env python3
"""Compare two trees of the port on one CUDA card, in one call.

    python3 chip_compare.py [--phases privunit,ssd,paper] OLD_SRC NEW_SRC [NEW_SRC OLD_SRC ...]

Each argument is a directory holding a ``repro_torch`` package (``src`` of a
checkout; an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The trees run one after another, each in a process of
its own, in the order given (old, new, new, old spreads drift over both), and
each measures, with ``chip_smoke.py``'s helpers of this checkout, the phases
that ``--phases`` names (all by default):

  host      always: the process's host speed, to read the host-bound
            rounds by: ms of 2000 launches of a one-element CUDA add
            (queued, then synchronised), ms of a fixed pure-Python loop,
            the CPU the process last ran on and how many it may use;
  privunit  phase 4's ldp-fedexp-privunit round at M = 1000, d = 131072,
            tau = 20 (``chip_smoke.FULL_SIZE``): ms a round on the host clock
            with the card synchronised, the stage/local/server split of three
            more rounds (``chip_smoke.split_round``, medians), the release
            alone on the staged noise and the noise draw, stage and release
            (CUDA events), the round's peak memory; it needs a tree whose
            rounds are staged (``fedsim.server.round_stage``);
  ssd       the plain ``ssd_chunked`` and ``_final_state`` at phase 2c's
            serve shape (``chip_smoke.SSD_SERVE``): ms (CUDA events) and the
            peak memory they allocate above their inputs;
  paper     the eager engine on phase 3's paper workload (M = 1000, tau =
            20, 50 rounds) for ldp-fedexp-gauss, cdp-fedexp and
            ldp-fedexp-privunit: ms a round of each of four runs after the
            first, host clock, the card synchronised;
  ops       the same sessions' host work a round, which the host's speed
            does not move: a second run under ``torch.profiler``, its CPU
            events counted a round (all, ``aten::`` ops, and each CUDA
            runtime call by name), and its kernels on the card.

Every run prints one JSON line ``{"src": ..., "host": {...}, "privunit": {...},
"ssd": {...}, "paper": {...}}`` (the phases run); the last lines are the
card's name and power limit and one JSON object with every run.  Exits
non-zero without a card.
"""
from __future__ import annotations

import json
import os
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

    def staged():
        return alg.stage_noise(alg.draw_noise(round_generator(3, 0), m, d, dev), dev)

    noise = staged()
    release_ms = cs.cuda_ms(lambda: alg.mechanism.release(noise, deltas), 5)
    draw_release_ms = cs.cuda_ms(lambda: alg.mechanism.release(staged(), deltas), 5)
    return dict(round_ms=round_ms, stage_ms=statistics.median(s[0] for s in splits),
                local_ms=statistics.median(s[1] for s in splits),
                server_ms=statistics.median(s[2] for s in splits), release_ms=release_ms,
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


def paper(cs, dev) -> dict:
    """ms a round of the eager paper workload: four runs of each session
    after its first."""
    m, tau, rounds = cs.PAPER
    out = {}
    for name in ("ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit"):
        d = 100 if "ldp" in name or "privunit" in name else 500
        session, _ = cs.make_session(name, m, d, rounds, tau, dev)
        session.run(0)
        out[name] = [1e3 * cs.timed_run(session)[1] / rounds for _ in range(4)]
    return out


def ops(cs, dev) -> dict:
    """Events a round of a profiled second run of each paper session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m, tau, rounds = cs.PAPER
    out = {}
    for name in ("ldp-fedexp-gauss", "cdp-fedexp", "ldp-fedexp-privunit"):
        d = 100 if "ldp" in name or "privunit" in name else 500
        session, _ = cs.make_session(name, m, d, rounds, tau, dev)
        session.run(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            session.run(0)
            torch.cuda.synchronize()
        events = prof.key_averages()
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        runtime = {e.key: e.count / rounds for e in cpu if e.key.startswith("cuda")}
        out[name] = dict(
            cpu_events=sum(e.count for e in cpu) / rounds,
            aten_ops=sum(e.count for e in cpu if e.key.startswith("aten::")) / rounds,
            kernels=sum(e.count for e in events if e.device_type == DeviceType.CUDA) / rounds,
            runtime=dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:8]))
    return out


def host(dev) -> dict:
    """The process's host speed: ms of 2000 one-element CUDA adds queued and
    synchronised, ms of a fixed pure-Python loop, the CPU it last ran on
    (``/proc/self/stat``) and the number it may run on."""
    import torch
    x = torch.zeros(1, device=dev)
    for _ in range(200):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    launch_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    loop_ms = 1e3 * (time.perf_counter() - t0)
    with open("/proc/self/stat") as f:
        cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    return dict(launch_2000_ms=launch_ms, python_loop_ms=loop_ms, cpu=cpu,
                cpus_allowed=len(os.sched_getaffinity(0)))


PHASES = ("privunit", "ssd", "paper", "ops")


def one(src: str, phases) -> int:
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
    out = dict(src=src, host=host(dev))
    for phase in phases:
        out[phase] = {"privunit": privunit, "ssd": ssd, "paper": paper, "ops": ops}[phase](cs, dev)
    out["host_after"] = host(dev)
    print(json.dumps(out))
    return 0 if out.get("ssd", {"finite": True})["finite"] else 1


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 2
    phases = PHASES
    if len(argv) >= 2 and argv[0] == "--phases":
        phases = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(phases) <= set(PHASES):
            print(f"chip_compare: --phases takes {','.join(PHASES)}", file=sys.stderr)
            return 2
    if len(argv) >= 2 and argv[0] == "--one":
        return one(argv[1], phases)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for src in argv:
        proc = subprocess.run([sys.executable, __file__, "--phases", ",".join(phases),
                               "--one", src], capture_output=True, text=True)
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
