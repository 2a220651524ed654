"""Declarative run specs (counterpart of repro/fedsim/specs.py).

The port runs full-batch local GD, full participation and the eager round
loop; ``LocalSpec``, ``CohortSpec``, ``ShardSpec``, ``StreamSpec`` and
``FaultSpec`` come with later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses

__all__ = ["TrainSpec", "EngineSpec"]


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """What to train: the paper-level knobs of one federated run."""

    rounds: int                 # T server rounds
    tau: int                    # local GD steps per client per round
    eta_l: float                # client learning rate
    avg_last: int = 2           # §5 iterate average over the trailing iterates
    eval_every: int = 1         # eval cadence; non-eval rounds record NaN

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.avg_last < 1:
            raise ValueError(f"avg_last must be >= 1, got {self.avg_last}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {self.eval_every}")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How the round loop runs.  The port has one engine so far: ``"eager"``,
    a plain Python loop of rounds.  The JAX package's ``"scan"`` and
    ``"stream"`` engines (their counterpart is CUDA graphs and chunked
    cohorts) come in later slices."""

    engine: str = "eager"

    def __post_init__(self):
        if self.engine in ("scan", "stream"):
            raise NotImplementedError(
                f"engine={self.engine!r} is not ported yet; the port runs 'eager'")
        if self.engine != "eager":
            raise ValueError(f"unknown engine {self.engine!r}; the port runs 'eager'")
