"""repro_torch.telemetry — round trackers for long runs (counterpart of
repro/telemetry; the trackers only: the engine tap and ``TelemetrySpec`` are
still to port, ROADMAP queue 1, item 15).

Public surface: the ``Tracker`` protocol and its concrete sinks, which a host
loop feeds directly (``examples/train_federated_lm_torch.py``).
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
