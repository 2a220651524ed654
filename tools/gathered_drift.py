"""Gathered against dense sampled runs, in the JAX package and in the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/gathered_drift.py [--seeds 3]

A sampled round trains either every client and masks the rows left out
(dense) or only the sampled clients, packed into a slot table (gathered).
The two are the same round: each package keys its mask and noise by global
client index, so a single round agrees to float32 rounding.  Over a whole
run the rounding can compound.  This script runs, on the CPU and in both
packages, the paper's synthetic linear regression (M = 1000, d = 500,
tau = 20, 50 rounds, benchmarks/e1_synthetic.py's hyperparameters) under
CohortSpec(q = 0.1), dense and gathered, from the same seed, and prints each
package's gap between the two runs: the largest |w_gathered - w_dense| of
the final iterate against max |w|, and the first round whose eta_g differs
by more than rtol 1e-5.  cdp-fedexp extrapolates (eta_g up to ~100 a round
under sampling); dp-scaffold in CDP mode (eta_g = 1, no extrapolation) is
the control.  Both packages get the JAX generator's data.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

M, D, TAU, ROUNDS, Q = 1000, 500, 20, 50, 0.1
HP = {"cdp-fedexp": (0.1, 0.3), "dp-scaffold": (0.3, 0.3)}   # (eta_l, C), e1's


def kwargs(name: str) -> dict:
    eta_l, c = HP[name]
    kw = dict(clip_norm=c, sigma=5 * c / math.sqrt(M), num_clients=M)
    if name == "dp-scaffold":
        kw.update(central=True, tau=TAU, eta_l=eta_l)
    return kw


def jax_runs(name: str, data: dict, seed: int):
    """(dense, gathered) final w and eta history of the JAX package."""
    import jax
    import jax.numpy as jnp

    from repro.core.fedexp import make_algorithm
    from repro.data.synthetic import linreg_loss
    from repro.fedsim import CohortSpec, FederatedSession, LocalSpec, TrainSpec
    out = []
    for gather in (False, True):
        s = FederatedSession(make_algorithm(name, **kwargs(name)), linreg_loss, jnp.zeros(D),
                             {"x": jnp.asarray(data["x"]), "y": jnp.asarray(data["y"])},
                             train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=HP[name][0]),
                             local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                             else None,
                             cohort=CohortSpec(q=Q, gather=gather))
        r = s.run(jax.random.PRNGKey(seed))
        out.append((np.asarray(r.final_w, np.float64), np.asarray(r.eta_history, np.float64)))
    return out


def port_runs(name: str, data: dict, seed: int):
    """(dense, gathered) final w and eta history of the port, on the CPU."""
    from repro_torch.core.fedexp import make_algorithm
    from repro_torch.data.synthetic import linreg_loss
    from repro_torch.fedsim import CohortSpec, FederatedSession, LocalSpec, TrainSpec
    out = []
    for gather in (False, True):
        s = FederatedSession(make_algorithm(name, **kwargs(name)), linreg_loss,
                             np.zeros(D, np.float32), {"x": data["x"], "y": data["y"]},
                             train=TrainSpec(rounds=ROUNDS, tau=TAU, eta_l=HP[name][0]),
                             local=LocalSpec(control_variates=True) if name == "dp-scaffold"
                             else None,
                             cohort=CohortSpec(q=Q, gather=gather), device="cpu")
        r = s.run(seed)
        out.append((r.final_w.double().numpy(), r.eta_history.double().numpy()))
    return out


def gap(runs) -> tuple[float, float, int | None]:
    """(max |w_g - w_d|, max |w_d|, first round with eta_g apart by > rtol 1e-5)."""
    (wd, ed), (wg, eg) = runs
    apart = np.nonzero(np.abs(eg - ed) > 1e-5 * np.abs(ed))[0]
    return (float(np.abs(wg - wd).max()), float(np.abs(wd).max()),
            int(apart[0]) if apart.size else None)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    import jax

    from repro.data.synthetic import make_synthetic_linreg
    d = make_synthetic_linreg(jax.random.PRNGKey(0), M, D)
    data = {k: np.array(getattr(d, k)) for k in ("x", "y")}
    print(f"M={M} d={D} tau={TAU} rounds={ROUNDS} CohortSpec(q={Q}): gathered vs dense, "
          "final w (CPU, float32)")
    for name in HP:
        for pkg, runs in (("jax", jax_runs), ("port", port_runs)):
            for seed in range(args.seeds):
                diff, scale, first = gap(runs(name, data, seed))
                print(f"{name:12s} {pkg:4s} seed {seed}: max |w_g - w_d| {diff:.3e} "
                      f"(max |w| {scale:.3f}, {diff / scale:.2e} of it); eta_g within rtol "
                      f"1e-5 {'throughout' if first is None else f'until round {first}'}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
