"""Algorithm registry (counterpart of the registry in repro/core/fedexp.py).

Every name is a (mechanism, step) composition under the uniform
``MeanAggregation``, but ``ldp-fedexp-perclient``: a sigma per client from
its own epsilon (``PerClientGaussian``) under the inverse-variance
``WeightedAggregation``, and ``dp-scaffold``: the control-variate server
``DPScaffoldServer``, run with ``LocalSpec(control_variates=True)``.  The
port builds all 17 of the JAX registry's names.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import compose as _compose
from repro_torch.core.algorithm import ServerAlgorithm
from repro_torch.core.variance_reduction import DPScaffoldServer

__all__ = ["make_algorithm", "list_algorithms"]


def _backend(kw) -> str:
    return kw.get("backend", "auto")


def _gauss_ldp(kw) -> _compose.GaussianLDP:
    return _compose.GaussianLDP(kw["clip_norm"], kw["sigma"], backend=_backend(kw))


def _privunit(kw) -> _compose.PrivUnitLDP:
    return _compose.PrivUnitLDP(kw["clip_norm"], kw["eps0"], kw["eps1"], kw["eps2"], kw["dim"])


def _cdp(kw) -> _compose.CentralGaussian:
    return _compose.CentralGaussian(clip_norm=kw["clip_norm"], sigma=kw["sigma"],
                                    num_clients=kw["num_clients"],
                                    sigma_xi=kw.get("sigma_xi"), backend=_backend(kw))


def _adaptive_cdp(kw) -> _compose.CentralGaussian:
    return _compose.CentralGaussian(z_mult=kw["z_mult"], num_clients=kw["num_clients"],
                                    backend=_backend(kw))


def _adaptive_step(kw) -> _compose.AdaptiveClipStep:
    return _compose.AdaptiveClipStep(c0=kw.get("c0", 1.0), gamma=kw.get("gamma", 0.5),
                                     clip_lr=kw.get("clip_lr", 0.2),
                                     sigma_b=kw.get("sigma_b", 10.0))


def _schedule(inner, kw) -> _compose.NoiseSchedule:
    return _compose.NoiseSchedule(inner=inner, decay=kw.get("decay", 1.0),
                                  boundaries=tuple(kw.get("boundaries", ())),
                                  scales=tuple(kw.get("scales", ())))


def _adam(kw) -> _compose.ServerOpt:
    return _compose.ServerOpt(kind="adam", lr=kw.get("server_lr", 0.1))


def _composed(name: str, mechanism, step) -> _compose.ComposedAlgorithm:
    return _compose.ComposedAlgorithm(mechanism=mechanism, step=step, name=name)


def _perclient_weighted(kw) -> _compose.ComposedAlgorithm:
    # per-client sigmas from the public epsilons, aggregated with the
    # matching public inverse-variance weights
    mechanism = _compose.PerClientGaussian(kw["clip_norm"], tuple(kw["epsilons"]), kw["delta"],
                                           backend=_backend(kw))
    return _compose.ComposedAlgorithm(
        mechanism=mechanism, step=_compose.FedEXPStep(),
        aggregation=_compose.WeightedAggregation(mechanism.inverse_variance_weights()),
        name="ldp-fedexp-perclient")


def _scaffold(kw) -> DPScaffoldServer:
    return DPScaffoldServer(clip_norm=kw["clip_norm"], sigma=kw["sigma"], central=kw["central"],
                            num_clients=kw["num_clients"], tau=kw["tau"], eta_l=kw["eta_l"],
                            backend=_backend(kw))


_FACTORIES: dict[str, Callable[..., ServerAlgorithm]] = {
    "fedavg": lambda **kw: _composed(
        "fedavg", _compose.NoPrivacy(), _compose.FixedEta()),
    "fedexp": lambda **kw: _composed(
        "fedexp", _compose.NoPrivacy(), _compose.FedEXPStep()),
    "dp-fedavg-ldp-gauss": lambda **kw: _composed(
        "dp-fedavg-ldp-gauss", _gauss_ldp(kw), _compose.FixedEta()),
    "ldp-fedexp-gauss": lambda **kw: _composed(
        "ldp-fedexp-gauss", _gauss_ldp(kw), _compose.FedEXPStep()),
    "dp-fedavg-privunit": lambda **kw: _composed(
        "dp-fedavg-privunit", _privunit(kw), _compose.FixedEta()),
    "ldp-fedexp-privunit": lambda **kw: _composed(
        "ldp-fedexp-privunit", _privunit(kw), _compose.FedEXPStep()),
    "dp-fedavg-cdp": lambda **kw: _composed(
        "dp-fedavg-cdp", _cdp(kw), _compose.FixedEta()),
    "cdp-fedexp": lambda **kw: _composed(
        "cdp-fedexp", _cdp(kw), _compose.FedEXPStep()),
    "dp-fedadam-cdp": lambda **kw: _composed(
        "dp-fedadam-cdp", _cdp(kw), _adam(kw)),
    "cdp-fedexp-adaptive-clip": lambda **kw: _composed(
        "cdp-fedexp-adaptive-clip", _adaptive_cdp(kw), _adaptive_step(kw)),
    "ldp-gauss-fedadam": lambda **kw: _composed(
        "ldp-gauss-fedadam", _gauss_ldp(kw), _adam(kw)),
    "cdp-fedmom": lambda **kw: _composed(
        "cdp-fedmom", _cdp(kw),
        _compose.ServerOpt(kind="momentum", lr=kw.get("server_lr", 1.0),
                           beta1=kw.get("server_beta", 0.9))),
    "privunit-fedexp-adaptive-clip": lambda **kw: _composed(
        "privunit-fedexp-adaptive-clip",
        _privunit({**kw, "clip_norm": kw.get("clip_norm", kw.get("c0", 1.0))}),
        _adaptive_step(kw)),
    "ldp-fedexp-schedule": lambda **kw: _composed(
        "ldp-fedexp-schedule", _schedule(_gauss_ldp(kw), kw), _compose.FedEXPStep()),
    "cdp-fedexp-schedule": lambda **kw: _composed(
        "cdp-fedexp-schedule", _schedule(_cdp(kw), kw), _compose.FedEXPStep()),
    "ldp-fedexp-perclient": lambda **kw: _perclient_weighted(kw),
    "dp-scaffold": lambda **kw: _scaffold(kw),
}


def list_algorithms() -> list[str]:
    """Sorted names of every server algorithm the port runs."""
    return sorted(_FACTORIES)


def make_algorithm(name: str, **kwargs) -> ServerAlgorithm:
    """Build a registered server algorithm by name.

    Args:
      name: one of ``list_algorithms()``.
      **kwargs: the composition's knobs, as the JAX registry's:
        ``clip_norm`` and ``sigma`` for the Gaussian names, plus
        ``num_clients`` (and optionally ``sigma_xi``) for CDP;
        ``eps0``/``eps1``/``eps2``/``dim`` for PrivUnit; ``z_mult``,
        ``num_clients`` and ``c0``/``gamma``/``clip_lr``/``sigma_b`` for
        adaptive clipping; ``server_lr`` (and ``server_beta`` for momentum)
        for the server optimizers; ``decay``/``boundaries``/``scales`` for
        the schedules; ``epsilons`` (one per client) and ``delta`` with
        ``clip_norm`` for ``ldp-fedexp-perclient``; ``clip_norm``,
        ``sigma``, ``central``, ``num_clients``, ``tau`` and ``eta_l`` for
        ``dp-scaffold`` (the server mirrors the local phase); ``backend``
        ("auto" | "kernel" | "kernel-fused" | "torch") for the Gaussian names
        and ``dp-scaffold``.
    """
    if name not in _FACTORIES:
        raise KeyError(f"unknown algorithm {name!r}; valid names: "
                       f"{', '.join(list_algorithms())}")
    return _FACTORIES[name](**kwargs)
