#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. build     nvcc builds the dp_aggregate kernels from csrc/ (ctypes).
  2. kernels   every kernel against its plain PyTorch version on the card, at
               the main path's shapes and a ragged one; fused-mode noise
               against the noise-only kernel; bitwise determinism; times.
  3. paper     the paper's synthetic linear regression (M=1000, tau=20,
               50 rounds; d=500 CDP/noiseless, d=100 LDP) for the six
               ported names, plus the two LDP names on the materialized-
               noise backend; launch counts must rise by one per round.
  4. full      ldp-fedexp-gauss (fused mode) and cdp-fedexp (none mode) at
               M=1000, d=131072 for 5 rounds: ms per round and its split.
  5. reference the port on the card against the port on the CPU (plain
               versions, same seeds, same noise) on a small problem.
Phases 3 and 4 are the main path: every launch counter is set to 0 before
them and read after.  The line before the last is {"kernels": [...]}, the
last {"ok": true, "device": {...}}.  It imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# operations per element of the (M, d) matrix.  none: norm fma (2), scale mul,
# column add; operand/fused add the noise add and the square fma (3 more).
# The counter generator adds ~131 ops (Threefry-2x32-20: 117 integer ops;
# two bits-to-float conversions: 8; Box-Muller: 6).  All are counted at the
# float32 rate, above the card's integer rate, so the bound stays a lower bound.
GEN_OPS = 131
OPS_PER_ELEM = {"none": 4, "operand": 7, "fused": 7 + GEN_OPS}
RTOL = 1e-5                 # sums: |k - p| <= RTOL * (|p| + max|p|)
NOISE_ATOL = 1e-5           # per element, in units of sigma: f32 log/cos/sqrt rounding

HP = {  # (eta_l, C) of benchmarks/e1_synthetic.py; noiseless names at eta_l 0.1
    "fedavg": (0.1, None), "fedexp": (0.1, None),
    "dp-fedavg-ldp-gauss": (0.3, 1.0), "ldp-fedexp-gauss": (0.3, 0.3),
    "dp-fedavg-cdp": (0.3, 3.0), "cdp-fedexp": (0.1, 0.3),
}
FEDEXP_NAMES = ("fedexp", "ldp-fedexp-gauss", "cdp-fedexp")


def fail(msg: str) -> None:
    """End the run with a non-zero exit and the reason."""
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def close(got, want, what: str, rtol: float = RTOL):
    """Max abs error of ``got`` vs ``want``; fails beyond rtol * (|want| + max|want|)."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    tol = rtol * (want.abs() + want.abs().max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        fail(f"{what}: max abs err {err.max().item():.3e} beyond rtol {rtol}")
    return err.max().item()


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time (ms) for the work, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def algo_kwargs(name: str, m: int):
    """(eta_l, make_algorithm kwargs) of the paper's protocol for ``name``:
    sigma = 5C/sqrt(M) for CDP, 0.7C for LDP."""
    eta_l, c = HP[name]
    if c is None:
        return eta_l, {}
    if "cdp" in name:
        return eta_l, dict(clip_norm=c, sigma=5 * c / math.sqrt(m), num_clients=m)
    return eta_l, dict(clip_norm=c, sigma=0.7 * c)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the card, from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build():
    """Phase 1: build the kernels with nvcc and print the time and ptxas report."""
    from repro_torch.kernels.dp_aggregate import build
    t0 = time.perf_counter()
    build.load_library()
    print(f"[1 build] dp_aggregate kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_log['seconds']:.2f} s)")
    for line in build.build_log["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())


def phase_kernels(dev):
    """Kernel vs plain at every shape and mode; returns the timing cases."""
    import torch
    from repro_torch.kernels.dp_aggregate import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1234)
    cases, noise_cases = [], []
    sigma, seed = 0.7, 0x5EED
    for m, d in ((1000, 500), (1000, 100), (1000, 131072), (37, 129)):
        # row norms spread over [0, 2] so that about half the rows clip at C = 1
        u = torch.randn(m, d, generator=gen, device=dev)
        u *= 2 * torch.rand(m, 1, generator=gen, device=dev) / math.sqrt(d)
        clip = 1.0
        opnoise = 0.5 * torch.randn(m, d, generator=gen, device=dev)
        big = m * d >= 10**8

        kn = ops.generate_ldp_noise(m, d, seed, sigma, device=dev)
        pn = ref.ldp_noise_ref(m, d, seed, sigma, device=dev)
        nerr = (kn - pn).abs().max().item()
        if not torch.isfinite(kn).all() or nerr > NOISE_ATOL * sigma:
            fail(f"ldp_noise ({m},{d}): max abs err {nerr:.3e} > {NOISE_ATOL} sigma")
        b_ms, b_by = bound(m * d * 4, m * d * GEN_OPS)
        noise_cases.append(dict(
            shape=[m, d], max_abs_err=nerr,
            ms=cuda_ms(lambda: ops.generate_ldp_noise(m, d, seed, sigma, device=dev), 10),
            plain_ms=cuda_ms(lambda: ref.ldp_noise_ref(m, d, seed, sigma, device=dev),
                             2 if big else 10, warmup=1),
            bound_ms=b_ms, bound_by=b_by))

        plain = {
            "none": lambda: ref.dp_aggregate_ref(u, None, clip),
            "operand": lambda: ref.dp_aggregate_ref(u, opnoise, clip),
            "fused": lambda: ref.dp_aggregate_ref(
                u, ref.ldp_noise_ref(m, d, seed, sigma, device=dev), clip),
        }
        for mode in ("none", "operand", "fused"):
            kw = dict(operand=dict(noise=opnoise),
                      fused=dict(noise_seed=seed, noise_sigma=sigma)).get(mode, {})
            got = ops.dp_aggregate_sums(u, clip, **kw)
            want = ref.dp_aggregate_ref(u, dict(operand=opnoise, fused=pn).get(mode), clip)
            err = max(close(g, w, f"dp_aggregate {mode} ({m},{d}) output {i}")
                      for i, (g, w) in enumerate(zip(got, want)))
            if mode == "fused":
                again = ops.dp_aggregate_sums(u, clip, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"dp_aggregate fused ({m},{d}): two launches differ in bits")
                as_operand = ops.dp_aggregate_sums(u, clip, kn)
                ferr = max(close(a, b, f"fused vs operand ({m},{d}) output {i}")
                           for i, (a, b) in enumerate(zip(got, as_operand)))
                print(f"    fused vs operand fed the noise-only kernel ({m},{d}): "
                      f"max abs err {ferr:.3e}")
            b_ms, b_by = bound(m * d * 4 * (2 if mode == "operand" else 1) + d * 4,
                               m * d * OPS_PER_ELEM[mode])
            cases.append(dict(
                shape=[m, d], mode=mode, max_abs_err=err,
                ms=cuda_ms(lambda: ops.dp_aggregate_sums(u, clip, **kw), 10),
                plain_ms=cuda_ms(plain[mode], 2 if big else 10, warmup=1),
                bound_ms=b_ms, bound_by=b_by))
            c = cases[-1]
            print(f"[2 kernels] dp_aggregate {mode:7s} ({m},{d}): max abs err {err:.3e}  "
                  f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        nc = noise_cases[-1]
        print(f"[2 kernels] ldp_noise ({m},{d}): max abs err {nerr:.3e}  kernel "
              f"{nc['ms']:.4f} ms  plain {nc['plain_ms']:.4f} ms  bound {nc['bound_ms']:.4f} ms")
        del u, opnoise, kn, pn, plain
        torch.cuda.empty_cache()
    return cases, noise_cases


def run_session(name, m, d, rounds, tau, dev, *, seed=0, backend="auto", data=None):
    """One FederatedSession run of ``name`` on the synthetic linear regression."""
    import torch
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.data.synthetic import distance_to_opt, linreg_loss, make_synthetic_linreg
    from repro_torch.fedsim import FederatedSession, TrainSpec

    if data is None:
        data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, d)
    eta_l, kw = algo_kwargs(name, m)
    session = FederatedSession(
        make_algorithm(name, backend=backend, **kw), linreg_loss, torch.zeros(d, device=dev),
        data.client_batches(), train=TrainSpec(rounds=rounds, tau=tau, eta_l=eta_l),
        eval_fn=distance_to_opt(data.w_star), device=dev)
    return session, session.run(seed), data


def check_run(name, result, rounds):
    """Finite histories of the right shape, and eta_g >= 1 for FedEXP names."""
    import torch
    eta = result.eta_history
    if eta.shape != (rounds,) or not torch.isfinite(eta).all() \
            or not torch.isfinite(result.final_w).all():
        fail(f"{name}: non-finite or misshapen results")
    if name in FEDEXP_NAMES and bool((eta < 1.0).any()):
        fail(f"{name}: eta_g < 1 in a FedEXP run")


def phase_paper(dev):
    """Phase 3: the paper workload for every ported name, with launch counts."""
    from repro_torch.kernels.dp_aggregate import ops
    m, tau, rounds = 1000, 20, 50
    finals = {}
    for name in HP:
        d = 100 if "ldp" in name else 500
        for backend in ("auto", "kernel") if "ldp" in name else ("auto",):
            before = (ops.dp_aggregate_sums.launches, ops.generate_ldp_noise.launches)
            t0 = time.perf_counter()
            _, r, data = run_session(name, m, d, rounds, tau, dev, backend=backend)
            dist = float(data.w_star.sub(r.final_w).norm())
            secs = time.perf_counter() - t0
            check_run(name, r, rounds)
            agg = ops.dp_aggregate_sums.launches - before[0]
            noise = ops.generate_ldp_noise.launches - before[1]
            want_noise = rounds if backend == "kernel" else 0
            if agg != rounds or noise != want_noise:
                fail(f"{name} [{backend}]: {agg} dp_aggregate and {noise} ldp_noise "
                     f"launches in {rounds} rounds (want {rounds} and {want_noise})")
            print(f"[3 paper] {name:20s} [{backend:6s}] d={d}: final ||w - w*|| = {dist:.4f}  "
                  f"eta_g in [{r.eta_history.min().item():.3f}, "
                  f"{r.eta_history.max().item():.3f}]  {secs:.2f} s")
            finals[(name, backend)] = r.final_w
    for name in ("dp-fedavg-ldp-gauss", "ldp-fedexp-gauss"):
        # the same seed keys the same noise: fused and materialized agree
        close(finals[(name, "kernel")], finals[(name, "auto")],
              f"{name}: kernel-fused vs materialized-noise backend")


def phase_full(dev, cases):
    """Phase 4: full-size rounds, timed, with the local/server split of one round."""
    import torch
    from repro_torch.core.algorithm import round_generator
    from repro_torch.data.synthetic import linreg_loss
    from repro_torch.fedsim import cohort_updates
    m, d, tau, rounds = 1000, 131072, 20, 5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    kernel_ms = {c["mode"]: c["ms"] for c in cases if c["shape"] == [m, d]}
    data = None
    for name, mode in (("ldp-fedexp-gauss", "fused"), ("cdp-fedexp", "none")):
        run_session(name, m, d, 1, tau, dev, data=data)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session, r, data = run_session(name, m, d, rounds, tau, dev, data=data)
        torch.cuda.synchronize()
        per_round = 1e3 * (time.perf_counter() - t0) / rounds
        check_run(name, r, rounds)
        # one more round split into local training and the server's release
        w, gen = r.last_w, round_generator(1, rounds)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        deltas = cohort_updates(linreg_loss, w, session.client_batches, tau,
                                session.train.eta_l)
        ev[1].record()
        session.algorithm.apply_round_stateful(gen, w, deltas, ())
        ev[2].record()
        torch.cuda.synchronize()
        print(f"[4 full] {name} M={m} d={d} tau={tau}: {per_round:.3f} ms/round "
              f"(local training {ev[0].elapsed_time(ev[1]):.3f} ms, server release+step "
              f"{ev[1].elapsed_time(ev[2]):.3f} ms); dp_aggregate {mode} kernel "
              f"{kernel_ms[mode]:.4f} ms/launch (CUDA events)  [{smi}]")
        del deltas
    torch.cuda.empty_cache()


def phase_reference(dev):
    """The port on the card (kernels) vs on the CPU (plain versions): the same
    seeds key the same LDP noise.  Tolerance 1e-4: float32 sums in other
    orders, amplified by the FedEXP ratio over five rounds."""
    m, d, tau, rounds = 40, 32, 5, 5
    for name in ("fedexp", "ldp-fedexp-gauss"):
        _, g, data = run_session(name, m, d, rounds, tau, dev, seed=7)
        cpu_data = type(data)(x=data.x.cpu(), y=data.y.cpu(), w_star=data.w_star.cpu())
        _, c, _ = run_session(name, m, d, rounds, tau, "cpu", seed=7, data=cpu_data)
        err = close(g.final_w.cpu(), c.final_w, f"{name}: card vs CPU final w", 1e-4)
        close(g.eta_history.cpu(), c.eta_history, f"{name}: card vs CPU eta history", 1e-4)
        print(f"[5 reference] {name}: card vs CPU max abs err of final w {err:.3e}")


def main() -> int:
    """Run every phase; 0 only when all of them passed on a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.dp_aggregate import ops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    cases, noise_cases = phase_kernels(dev)

    ops.dp_aggregate_sums.launches = 0
    ops.generate_ldp_noise.launches = 0
    phase_paper(dev)
    phase_full(dev, cases)
    launches = {"dp_aggregate": ops.dp_aggregate_sums.launches,
                "ldp_noise": ops.generate_ldp_noise.launches}
    for k, n in launches.items():
        if n < 1:
            fail(f"kernel {k} was never launched on the main path")

    phase_reference(dev)

    src = "src/repro_torch/kernels/dp_aggregate/csrc/dp_aggregate.cu"
    head = next(c for c in cases if c["shape"] == [1000, 131072] and c["mode"] == "fused")
    nhead = next(c for c in noise_cases if c["shape"] == [1000, 131072])
    kernels = [
        dict(name="dp_aggregate", route="cuda", source=src,
             replaces="src/repro/kernels/dp_aggregate/kernel.py:99",
             launches=launches["dp_aggregate"], max_abs_err=max(c["max_abs_err"] for c in cases),
             ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
             bound_by=head["bound_by"], library_ms=None, headline="fused (1000, 131072)",
             cases=cases),
        dict(name="ldp_noise", route="cuda", source=src,
             replaces="src/repro/kernels/dp_aggregate/kernel.py:222",
             launches=launches["ldp_noise"],
             max_abs_err=max(c["max_abs_err"] for c in noise_cases),
             ms=nhead["ms"], plain_ms=nhead["plain_ms"], bound_ms=nhead["bound_ms"],
             bound_by=nhead["bound_by"], library_ms=None, headline="(1000, 131072)",
             cases=noise_cases),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
