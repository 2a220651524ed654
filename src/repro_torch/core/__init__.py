"""Core DP-FedEXP library of the port — the paper's contribution in PyTorch."""

from repro_torch.core import (
    accounting,
    adaptive_clip,
    aggregation,
    clipping,
    compose,
    compression,
    mechanisms,
    stepsize,
)
from repro_torch.core.aggregation import (
    RoundMoments,
    RoundStats,
    aggregate_stats,
    fused_clip_aggregate,
    partial_clip_moments,
    raw_moments,
)
from repro_torch.core.algorithm import RoundAux, RoundNoise, ServerAlgorithm
from repro_torch.core.clipping import clip_batch, clip_by_l2, clip_tree, global_l2_norm_tree
from repro_torch.core.compose import (
    AdaptiveClipStep,
    CentralGaussian,
    ComposedAlgorithm,
    CompressionCarry,
    CountSketchAggregation,
    FedEXPStep,
    FixedEta,
    GaussianLDP,
    MeanAggregation,
    NoiseSchedule,
    NoPrivacy,
    PerClientGaussian,
    PrivUnitLDP,
    RandKAggregation,
    ServerOpt,
    WeightedAggregation,
    compose_algorithm,
    with_compression,
)
from repro_torch.core.compression import COMPRESS_TAG
from repro_torch.core.fedexp import list_algorithms, make_algorithm

__all__ = [
    "accounting", "adaptive_clip", "aggregation", "clipping", "compose", "compression",
    "mechanisms", "stepsize",
    "RoundStats", "RoundMoments", "aggregate_stats", "fused_clip_aggregate",
    "partial_clip_moments", "raw_moments",
    "clip_batch", "clip_by_l2", "clip_tree", "global_l2_norm_tree",
    "ServerAlgorithm", "RoundAux", "RoundNoise", "make_algorithm", "list_algorithms",
    "ComposedAlgorithm", "compose_algorithm",
    "NoPrivacy", "GaussianLDP", "PerClientGaussian", "PrivUnitLDP", "CentralGaussian",
    "NoiseSchedule", "MeanAggregation", "WeightedAggregation", "FixedEta", "FedEXPStep",
    "ServerOpt", "AdaptiveClipStep",
    "RandKAggregation", "CountSketchAggregation", "CompressionCarry", "with_compression",
    "COMPRESS_TAG",
]
