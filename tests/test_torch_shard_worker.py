"""One rank of the two-rank gloo group of ``test_torch_shard.py``.

    python tests/test_torch_shard_worker.py CASES RANK WORLD STORE OUT

joins a gloo process group of WORLD ranks through the file store STORE (no
network: gloo's sockets stay on the loopback device), builds the client mesh
and runs every case of the pickled dict CASES under ``ShardSpec(mesh)``, and
the unsharded session too where a case asks for it; the results go to OUT,
a pickle of one dict a case.  It imports the port alone (no JAX), so the
children start quickly; ``test_torch_shard.py`` builds the cases (data, the
JAX package's draws to replay) and holds the results to the JAX package.
It holds no test of its own.

A case is a dict: ``name`` (a registry name), ``kw`` (its make_algorithm
kwargs), ``agg`` (None, or a compression layer's (class name, kwargs)),
``data`` (numpy client arrays), ``rounds``, ``tau``, ``eta_l``, ``seed``,
``specs`` (FederatedSession keywords as (spec class name, kwargs) pairs),
``noises`` (round -> ``RoundNoise`` to replay, or None for the port's own
draws), ``masks`` (the rounds' cohort masks to replay, or None), ``faults``
(round seed -> the fault draws to replay, or None), ``unsharded`` (also
run the session without a mesh) and ``recover`` (None, or the sharded run's
``checkpoint_dir`` and ``checkpoint_every``, shared by the ranks, under
``RecoveryPolicy(max_retries=2)`` with round 0's first attempt poisoned:
the run rolls back to the checkpoint it wrote before its first round).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.core import compose as tcomp  # noqa: E402
from repro_torch.core.algorithm import all_reduce_moments, round_generator  # noqa: E402
from repro_torch.core.fedexp import make_algorithm  # noqa: E402
from repro_torch.data.synthetic import linreg_loss  # noqa: E402
from repro_torch.fedsim import server as srv  # noqa: E402
from repro_torch.fedsim import specs as tspecs  # noqa: E402
from repro_torch.fedsim.session import FederatedSession, RecoveryPolicy  # noqa: E402

RESULT = ("final_w", "last_w", "eta_history", "metric_history", "eta_naive_history",
          "eta_target_history")


class Replay(tcomp.ComposedAlgorithm):
    """A composition whose round t draws a given ``RoundNoise`` (JAX's)."""

    def __init__(self, alg, noises):
        super().__init__(alg.mechanism, alg.step, alg.aggregation, alg.name)
        object.__setattr__(self, "noises", noises)

    def draw_noise(self, gen, m, d, device, t=None):
        return self.noises[t]


@dataclasses.dataclass(frozen=True)
class ReplayCohort(tspecs.CohortSpec):
    """A cohort whose round masks are given (JAX's), found by the round's seed."""

    masks: tuple = ()
    seeds: tuple = ()

    def round_mask(self, gen, num_clients):
        return self.masks[self.seeds.index(gen.initial_seed())]


def algorithm(case):
    """The case's algorithm: the registry name, its compression layer, the
    JAX package's draws replayed."""
    alg = make_algorithm(case["name"], **case["kw"])
    if case["agg"] is not None:
        cls, kw = case["agg"]
        alg = tcomp.with_compression(alg, getattr(tcomp, cls)(**kw))
    return alg if case["noises"] is None else Replay(alg, case["noises"])


def specs(case):
    """The session's spec keywords; a replayed cohort keeps the spec's fields."""
    out = {}
    for key, (cls, kw) in case["specs"].items():
        if key == "cohort" and case["masks"] is not None:
            seeds = tuple(round_generator(case["seed"], t).initial_seed()
                          for t in range(case["rounds"]))
            out[key] = ReplayCohort(**kw, masks=tuple(torch.tensor(m) for m in case["masks"]),
                                    seeds=seeds)
        else:
            out[key] = getattr(tspecs, cls)(**kw)
    return out


def poison_first_attempt(carry, attempt):
    """A non-finite model in the first attempt of the run's first chunk."""
    if attempt >= 1:
        return carry
    w = carry[0].clone()
    w[0] = float("inf")
    return (w,) + tuple(carry[1:])


def run(case, shard=None):
    """One session of the case: its result's fields as numpy arrays; a
    sharded recovering run adds its ``fault_round`` and rounds retried."""
    kw = specs(case)
    if shard is not None:
        kw["shard"] = shard
    session = FederatedSession(algorithm(case), linreg_loss,
                               np.zeros(case["data"]["x"].shape[-1], np.float32),
                               {k: case["data"][k] for k in ("x", "y")},
                               train=tspecs.TrainSpec(rounds=case["rounds"], tau=case["tau"],
                                                      eta_l=case["eta_l"]),
                               local=tspecs.LocalSpec(control_variates=True)
                               if case["name"] == "dp-scaffold" else None,
                               device="cpu", **kw)
    recover = case.get("recover") if shard is not None else None
    if recover is None:
        result = session.run(case["seed"])
        return {f: getattr(result, f).numpy() for f in RESULT}
    session._inject_divergence = poison_first_attempt
    result = session.run(case["seed"], checkpoint_dir=recover["dir"],
                         checkpoint_every=recover["every"],
                         on_divergence=RecoveryPolicy(max_retries=2))
    out = {f: getattr(result, f).numpy() for f in RESULT}
    out.update(fault_round=result.fault_round, retried=session._rounds_retried,
               latest=ckpt.latest_step(recover["dir"]))
    return out


def run_case(case, shard):
    """The sharded run, its all-reduces, and the unsharded run if asked."""
    real = srv.fault_masks
    if case["faults"] is not None:
        table = {s: tuple(None if v is None else torch.tensor(v) for v in f)
                 for s, f in case["faults"].items()}
        srv.fault_masks = lambda fault, seed, m: table[seed]
    try:
        before = all_reduce_moments.launches
        out = {"sharded": run(case, shard), "all_reduces": all_reduce_moments.launches - before}
        if case["unsharded"]:
            out["unsharded"] = run(case)
    finally:
        srv.fault_masks = real
    return out


def main(argv) -> int:
    cases_path, rank, world, store, out_path = argv
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=int(rank),
                            world_size=int(world))
    try:
        shard = tspecs.ShardSpec(mesh=make_client_mesh())
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {cid: run_case(case, shard) for cid, case in cases.items()}
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
