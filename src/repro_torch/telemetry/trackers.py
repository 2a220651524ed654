"""Pluggable per-round event sinks (a copy of repro/telemetry/trackers.py).

A ``Tracker`` receives one event dict per federated round, plus control
events (rollbacks, profile windows).  The protocol is deliberately tiny so
sinks stay trivial to write:

    log(step, event)          one dict per round (or control event)
    start_phase(name, step)   run/resume/replay boundaries (no round payload)
    finish()                  flush/close at the end of a run

Concrete sinks:

* ``NullTracker`` — swallows everything.
* ``StdoutTracker`` — one human-readable line per event, optional cadence.
* ``JsonlTracker`` — one JSON object per line, atomic append (open/write/
  close per event, one buffered write each), non-finite floats sanitized to
  null so every line is strict JSON.
* ``CompositeTracker`` — fan out to several sinks.
* ``WandbTracker`` — optional adapter; constructing it without wandb
  installed raises ImportError.

Every tracker supports ``sub(tag)`` — a child view that stamps ``seed: tag``
into each event and forwards to the parent, with a no-op ``finish``.

Pure Python, the JAX package's lines byte for byte.  ``FederatedSession``
feeds it through the engine tap (``telemetry/tap.py``); host loops feed it
directly (``examples/train_federated_lm_torch.py``).
"""
from __future__ import annotations

import json
import math
import os
from typing import Any

__all__ = ["Tracker", "NullTracker", "StdoutTracker", "JsonlTracker",
           "CompositeTracker", "WandbTracker"]


class Tracker:
    """Base protocol; subclasses override what they need."""

    def log(self, step: int, event: dict[str, Any]) -> None:
        raise NotImplementedError

    def start_phase(self, name: str, step: int = 0) -> None:
        """A run boundary: 'run' at 0, 'resume' at the resumed round,
        'replay' for run_batched's post-hoc per-seed replays."""

    def finish(self) -> None:
        """Flush/close at the end of a run."""

    def sub(self, tag) -> "Tracker":
        """Per-seed child view: stamps ``seed: tag``, no-op finish."""
        return _SubTracker(self, tag)


class NullTracker(Tracker):
    """Swallow everything."""

    def log(self, step: int, event: dict[str, Any]) -> None:
        pass


class StdoutTracker(Tracker):
    """One line per event on stdout; ``every`` thins round events (control
    events — anything carrying an ``event`` key — always print)."""

    def __init__(self, every: int = 1, prefix: str = ""):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = every
        self.prefix = prefix

    def log(self, step: int, event: dict[str, Any]) -> None:
        if "event" not in event and step % self.every != 0:
            return
        body = "  ".join(f"{k}={_fmt(v)}" for k, v in event.items())
        print(f"{self.prefix}[round {step:5d}] {body}", flush=True)

    def start_phase(self, name: str, step: int = 0) -> None:
        print(f"{self.prefix}-- {name} from round {step} --", flush=True)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _sanitize(v):
    """Strict-JSON scrub: non-finite floats become null, containers recurse."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


class JsonlTracker(Tracker):
    """One JSON object per line, appended atomically.

    Each ``log`` opens the file in append mode, writes ONE buffered line and
    closes — a single write() per event at close, so concurrent writers
    never interleave partial lines.  Round events carry ``round``; control
    events carry ``event``.  Non-finite floats are written as null so every
    line parses under strict JSON (``tools/check_telemetry.py`` validates).
    """

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if not append and os.path.exists(path):
            os.remove(path)

    def _write(self, obj: dict[str, Any]) -> None:
        line = json.dumps(_sanitize(obj), sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def log(self, step: int, event: dict[str, Any]) -> None:
        self._write({"round": int(step), **event})

    def start_phase(self, name: str, step: int = 0) -> None:
        # phases are bookkeeping, not rounds: no line, so a plain T-round run
        # emits exactly T lines
        self._last_phase = (name, int(step))


class CompositeTracker(Tracker):
    """Fan every call out to each child sink, in order."""

    def __init__(self, *trackers: Tracker):
        self.trackers = tuple(trackers)

    def log(self, step: int, event: dict[str, Any]) -> None:
        for t in self.trackers:
            t.log(step, event)

    def start_phase(self, name: str, step: int = 0) -> None:
        for t in self.trackers:
            t.start_phase(name, step)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


class WandbTracker(Tracker):
    """Optional wandb adapter.  Importing this module never touches wandb;
    CONSTRUCTING the tracker does, and raises ImportError when the package
    is absent."""

    def __init__(self, run=None, **init_kwargs):
        import wandb  # deferred: repo does not depend on wandb
        self._run = run if run is not None else wandb.init(**init_kwargs)

    def log(self, step: int, event: dict[str, Any]) -> None:
        self._run.log(dict(event), step=int(step))

    def finish(self) -> None:
        self._run.finish()


class _SubTracker(Tracker):
    """Per-seed view over a parent tracker."""

    def __init__(self, parent: Tracker, tag):
        self.parent = parent
        self.tag = tag

    def log(self, step: int, event: dict[str, Any]) -> None:
        self.parent.log(step, {"seed": self.tag, **event})

    def start_phase(self, name: str, step: int = 0) -> None:
        self.parent.start_phase(f"{name}[seed={self.tag}]", step)

    def finish(self) -> None:
        pass  # the parent outlives every per-seed view
