"""Remark 3.1 on the PyTorch port: one step-size rule, every noise scale, no retuning.

    PYTHONPATH=src python examples/hyperfree_adaptivity_torch.py          # on the card
    PYTHONPATH=src python examples/hyperfree_adaptivity_torch.py --cpu

The counterpart of ``examples/hyperfree_adaptivity.py``, with its constants.
It runs CDP-FedEXP with the same configuration across a sweep of noise
levels (1, 3 and 10 times the paper's sigma = 5 C / sqrt(M)) and cohort
sizes (M = 200 and 1000).  The adaptive eta_g shrinks by itself as the
effective noise d sigma^2 / M grows: the behaviour that a server learning
rate would otherwise need a privacy-leaking grid search for.  The data come
from a seeded ``torch.Generator`` (``repro_torch.data.synthetic``), so the
numbers differ from the JAX example's draws.
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
from repro_torch.fedsim import FederatedSession, TrainSpec  # noqa: E402

D, TAU, ROUNDS, CLIP, ETA_L = 200, 20, 30, 0.3, 0.1
COHORTS = (200, 1000)
NOISE_MULTS = (1.0, 3.0, 10.0)


def main(device: str = "cuda") -> list[tuple[int, float, float, float]]:
    """Print the table and return its rows: (M, noise multiple, mean eta_g,
    final distance to w*)."""
    dev = torch.device(device)
    rows = []
    print(f"{'M':>6} {'sigma_mult':>10} {'mean eta_g':>10} {'final dist':>11}")
    for m in COHORTS:
        data = make_synthetic_linreg(torch.Generator(device=dev).manual_seed(0), m, D)
        for noise_mult in NOISE_MULTS:
            sigma = noise_mult * 5 * CLIP / math.sqrt(m)
            alg = make_algorithm("cdp-fedexp", clip_norm=CLIP, sigma=sigma, num_clients=m)
            session = FederatedSession(
                alg, linreg_loss, torch.zeros(D, device=dev), data.client_batches(),
                train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=ETA_L),
                eval_fn=distance_to_opt(data.w_star), device=dev)
            r = session.run(7)
            eta, dist = float(r.eta_history.mean()), float(r.metric_history[-1])
            rows.append((m, noise_mult, eta, dist))
            print(f"{m:>6} {noise_mult:>10.1f} {eta:>10.2f} {dist:>11.4f}")
    print("\neta_g falls as noise grows and rises with cohort size M:")
    print("the rule is adaptive to the EFFECTIVE noise d*sigma^2/M (Remark 3.1).")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    main(device="cpu" if ap.parse_args().cpu else "cuda")
