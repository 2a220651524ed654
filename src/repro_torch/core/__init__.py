"""Core DP-FedEXP library of the port — the paper's contribution in PyTorch."""

from repro_torch.core import (
    accounting,
    adaptive_clip,
    aggregation,
    clipping,
    compose,
    mechanisms,
    stepsize,
)
from repro_torch.core.aggregation import RoundStats, aggregate_stats, fused_clip_aggregate
from repro_torch.core.algorithm import RoundAux, RoundNoise, ServerAlgorithm
from repro_torch.core.clipping import clip_batch, clip_by_l2, global_l2_norm_tree
from repro_torch.core.compose import (
    AdaptiveClipStep,
    CentralGaussian,
    ComposedAlgorithm,
    FedEXPStep,
    FixedEta,
    GaussianLDP,
    MeanAggregation,
    NoiseSchedule,
    NoPrivacy,
    PrivUnitLDP,
    ServerOpt,
    compose_algorithm,
)
from repro_torch.core.fedexp import list_algorithms, make_algorithm

__all__ = [
    "accounting", "adaptive_clip", "aggregation", "clipping", "compose", "mechanisms",
    "stepsize",
    "RoundStats", "aggregate_stats", "fused_clip_aggregate",
    "clip_batch", "clip_by_l2", "global_l2_norm_tree",
    "ServerAlgorithm", "RoundAux", "RoundNoise", "make_algorithm", "list_algorithms",
    "ComposedAlgorithm", "compose_algorithm",
    "NoPrivacy", "GaussianLDP", "PrivUnitLDP", "CentralGaussian", "NoiseSchedule",
    "MeanAggregation", "FixedEta", "FedEXPStep", "ServerOpt", "AdaptiveClipStep",
]
