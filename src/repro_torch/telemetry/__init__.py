"""repro_torch.telemetry — round trackers and the engine tap (counterpart of
repro/telemetry).

Public surface: the ``Tracker`` protocol and its concrete sinks, which
``FederatedSession.run(seed, tracker=...)`` (and ``resume``, ``run_batched``)
feeds through the engine tap (``tap.TapSession``: one event a round in the
JAX package's schema), or a host loop feeds directly
(``examples/train_federated_lm_torch.py``).
"""
from repro_torch.telemetry.trackers import (
    CompositeTracker,
    JsonlTracker,
    NullTracker,
    StdoutTracker,
    Tracker,
    WandbTracker,
)

__all__ = ["Tracker", "NullTracker", "StdoutTracker", "JsonlTracker",
           "CompositeTracker", "WandbTracker"]
