"""Algorithm registry (counterpart of the registry in repro/core/fedexp.py).

Every name is a (mechanism, step) composition under the uniform
``MeanAggregation``.  This slice ports the paper's noiseless and Gaussian
names; the JAX package's other names raise ``NotImplementedError`` naming the
slice that brings them (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import compose as _compose
from repro_torch.core.algorithm import ServerAlgorithm

__all__ = ["make_algorithm", "list_algorithms"]


def _backend(kw) -> str:
    return kw.get("backend", "auto")


def _gauss_ldp(kw) -> _compose.GaussianLDP:
    return _compose.GaussianLDP(kw["clip_norm"], kw["sigma"], backend=_backend(kw))


def _cdp(kw) -> _compose.CentralGaussian:
    return _compose.CentralGaussian(clip_norm=kw["clip_norm"], sigma=kw["sigma"],
                                    num_clients=kw["num_clients"],
                                    sigma_xi=kw.get("sigma_xi"), backend=_backend(kw))


def _composed(name: str, mechanism, step) -> _compose.ComposedAlgorithm:
    return _compose.ComposedAlgorithm(mechanism=mechanism, step=step, name=name)


_FACTORIES: dict[str, Callable[..., ServerAlgorithm]] = {
    "fedavg": lambda **kw: _composed(
        "fedavg", _compose.NoPrivacy(), _compose.FixedEta()),
    "fedexp": lambda **kw: _composed(
        "fedexp", _compose.NoPrivacy(), _compose.FedEXPStep()),
    "dp-fedavg-ldp-gauss": lambda **kw: _composed(
        "dp-fedavg-ldp-gauss", _gauss_ldp(kw), _compose.FixedEta()),
    "ldp-fedexp-gauss": lambda **kw: _composed(
        "ldp-fedexp-gauss", _gauss_ldp(kw), _compose.FedEXPStep()),
    "dp-fedavg-cdp": lambda **kw: _composed(
        "dp-fedavg-cdp", _cdp(kw), _compose.FixedEta()),
    "cdp-fedexp": lambda **kw: _composed(
        "cdp-fedexp", _cdp(kw), _compose.FedEXPStep()),
}

# the JAX package's other registry names, with the slice that ports each
_LATER: dict[str, str] = {
    "dp-fedavg-privunit": "the PrivUnit slice (queue 1, item 8)",
    "ldp-fedexp-privunit": "the PrivUnit slice (queue 1, item 8)",
    "privunit-fedexp-adaptive-clip":
        "the PrivUnit and adaptive-clip slices (queue 1, items 8 and 11)",
    "cdp-fedexp-adaptive-clip": "the adaptive-clip slice (queue 1, item 11)",
    "dp-fedadam-cdp": "the server-optimizer slice (queue 1, item 11)",
    "ldp-gauss-fedadam": "the server-optimizer slice (queue 1, item 11)",
    "cdp-fedmom": "the server-optimizer slice (queue 1, item 11)",
    "ldp-fedexp-perclient": "the heterogeneous-privacy slice (queue 1, item 11)",
    "ldp-fedexp-schedule": "the noise-schedule slice (queue 1, item 11)",
    "cdp-fedexp-schedule": "the noise-schedule slice (queue 1, item 11)",
    "dp-scaffold": "the variance-reduction slice (queue 1, item 11)",
}


def list_algorithms() -> list[str]:
    """Sorted names of every server algorithm the port runs."""
    return sorted(_FACTORIES)


def make_algorithm(name: str, **kwargs) -> ServerAlgorithm:
    """Build a registered server algorithm by name.

    Args:
      name: one of ``list_algorithms()``.
      **kwargs: the composition's knobs: ``clip_norm`` and ``sigma`` for the
        Gaussian names, plus ``num_clients`` (and optionally ``sigma_xi``)
        for CDP; ``backend`` ("auto" | "kernel" | "kernel-fused" | "torch")
        for the Gaussian names.
    """
    if name in _LATER:
        raise NotImplementedError(f"{name!r} is not ported yet; it comes with {_LATER[name]} "
                                  "of ROADMAP.md")
    if name not in _FACTORIES:
        raise KeyError(f"unknown algorithm {name!r}; valid names: "
                       f"{', '.join(list_algorithms())}")
    return _FACTORIES[name](**kwargs)
