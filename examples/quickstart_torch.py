"""Quickstart on the PyTorch port: DP-FedEXP vs DP-FedAvg through the session API.

    PYTHONPATH=src python examples/quickstart_torch.py            # paper-scale CDP run, on the card
    PYTHONPATH=src python examples/quickstart_torch.py --quick    # a smoke run (seconds)
    PYTHONPATH=src python examples/quickstart_torch.py --quick --cpu

The counterpart of ``examples/quickstart.py``, with its flags.  It runs the
paper's CDP setting (M = 1000 clients, tau = 20 local steps, 50 rounds) and
prints the distance to the shared optimum, the adaptive step size and the
privacy budget.  A run is a ``FederatedSession`` bound to frozen specs:

    TrainSpec(rounds, tau, eta_l)     what to train
    EngineSpec("scan")                how to run it: each round staged on the
                                      host and replayed from a CUDA graph
                                      captured once per round kind (the
                                      eager engine's bits)
    CohortSpec(q=0.25)                per-round client sampling with
                                      amplification-aware accounting

``--telemetry out.jsonl`` streams one event a round (eta, metric, the
cumulative privacy ledger, the round's time) to a JSONL file per algorithm;
the results equal the untracked run's in bits.  ``--schedule`` adds
``cdp-fedexp-schedule`` under sigma(t) = sigma0 * 0.9**t; its stream carries
each round's sigma, which ``tools/check_telemetry.py --sigma0 S
--sigma-decay 0.9`` holds to the schedule.  The data come from a seeded
``torch.Generator`` (``repro_torch.data.synthetic``), so the numbers differ
from the JAX example's draws.
"""
import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)
from repro_torch.fedsim import CohortSpec, EngineSpec, FederatedSession, TrainSpec  # noqa: E402
from repro_torch.telemetry import JsonlTracker  # noqa: E402

# the JAX example's (eta_l, C) per algorithm
HPS = {"dp-fedavg-cdp": (0.3, 3.0), "cdp-fedexp": (0.1, 0.3),
       "cdp-fedexp-schedule": (0.1, 0.3)}

# sigma(t) = sigma0 * SCHEDULE_DECAY**t; the telemetry check pins this decay
SCHEDULE_DECAY = 0.9


def main(quick: bool = False, sampled_q: float | None = None, telemetry: str | None = None,
         schedule: bool = False, device: str = "cuda") -> dict:
    """Run the legs and return each one's ``(RunResult, PrivacyReport)`` by name."""
    m, d, rounds, tau = (120, 64, 8, 5) if quick else (1000, 500, 50, 20)
    dev = torch.device(device)
    data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, d)
    w0 = torch.zeros(d, device=dev)
    eval_fn = distance_to_opt(data.w_star)
    cohort = CohortSpec() if sampled_q is None else CohortSpec(q=sampled_q)
    eval_every = 2 if quick else 10

    names = ["dp-fedavg-cdp", "cdp-fedexp"]
    if schedule:
        names.append("cdp-fedexp-schedule")
    out = {}
    for name in names:
        eta_l, clip = HPS[name]
        kw = dict(clip_norm=clip, sigma=5 * clip / math.sqrt(m), num_clients=m)
        if name == "cdp-fedexp-schedule":
            kw["decay"] = SCHEDULE_DECAY
        session = FederatedSession(
            make_algorithm(name, **kw), linreg_loss, w0, data.client_batches(),
            train=TrainSpec(rounds=rounds, tau=tau, eta_l=eta_l, eval_every=eval_every),
            engine=EngineSpec("scan"), cohort=cohort, eval_fn=eval_fn, device=dev)
        # one tracker file per algorithm: q.jsonl -> q-<alg>.jsonl
        tracker = None
        if telemetry is not None:
            stem, dot, ext = telemetry.rpartition(".")
            path = f"{stem}-{name}.{ext}" if dot else f"{telemetry}-{name}"
            tracker = JsonlTracker(path)
        result = session.run(42, tracker=tracker)
        dist = float(eval_fn(result.final_w))
        etas = result.eta_history
        report = session.privacy_report(delta=1e-5)
        print(f"{name:20s}  final ||w - w*|| = {dist:8.4f}   "
              f"eta_g: first={float(etas[0]):.2f} last={float(etas[-1]):.2f}   "
              f"eps={report.eps_numerical:.2f}")
        trail = "  ".join(f"t={t}: {v:.3f}" for t, v in result.eval_rounds()[-3:])
        print(f"{'':20s}  ||w - w*|| trail: {trail}")
        out[name] = (result, report)

    print("\nDP-FedEXP reaches a closer iterate at the SAME privacy budget:")
    print("the global step size is derived from already-privatized statistics.")
    if sampled_q is not None:
        print(f"(sampled cohorts q={sampled_q}: epsilon accounts for the subsampled release, "
              "see accounting.cdp_budget)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small geometry for smoke runs")
    ap.add_argument("--sampled-q", type=float, default=None,
                    help="per-round Bernoulli client sampling rate")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="stream per-round JSONL telemetry to PATH (one file per algorithm)")
    ap.add_argument("--schedule", action="store_true",
                    help="also run cdp-fedexp under a decaying noise schedule "
                         f"sigma(t) = sigma0 * {SCHEDULE_DECAY}**t")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args()
    main(quick=args.quick, sampled_q=args.sampled_q, telemetry=args.telemetry,
         schedule=args.schedule, device="cpu" if args.cpu else "cuda")
