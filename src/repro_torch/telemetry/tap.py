"""Host side of the engine tap (counterpart of repro/telemetry/tap.py).

Every engine builds one fixed-layout float32 payload a round on the device
(``fedsim/server.py::tap_payload``, twelve slots in the JAX package's
order); this module turns payloads into tracker events.  There is no
callback from the device: the eager and streamed engines hand each round's
payload over after the round (only a tracked run reads it), and the scan
engine hands over a chunk's payloads in round order when the chunk ends.

A ``TapSession`` lives for one tracked ``run()``, and the session hands it
to the round loop explicitly.  ``install`` / ``uninstall`` / ``active`` are
the JAX package's registry, kept for parity: the session installs its tap
for the run, so two tracked runs cannot overlap in one process as in JAX,
but nothing in the port reads ``active()`` (in JAX the device callback
finds the tap there; the port has no device callback).  It owns:

* the reorder buffer and the next round expected (reset on a rollback);
* the round's wall time: ``round_time_s`` given by the engine (the scan
  engine's CUDA-event times), else the ``perf_counter`` time between
  deliveries;
* the cumulative privacy ledger (``ledger_fn(rounds_executed)`` ->
  ``PrivacyReport``; every executed round counts, rounds later rolled back
  included, as the privacy report composes them), behind a firewall: an
  accounting failure becomes one ``ledger_error`` field and disables the
  ledger, never an exception;
* frozen rounds: after a watchdog trip the scan engine's later rounds carry
  NaN payloads and a ``fault_t`` below their round; they are logged as
  frozen and charge no ledger.

Under client sharding every rank runs the same rounds and holds the same
payloads; only shard 0 reports (``shard``), as the JAX package keeps shard
0's emissions: the other ranks' taps log nothing.

The JAX package's ``device_emit`` (an ``io_callback`` out of the compiled
round) has no counterpart: the engines hand each round's payload to
``TapSession.emit`` on the host.
"""
from __future__ import annotations

import math
import time

import numpy as np

__all__ = ["TapSession", "install", "uninstall", "active", "PAYLOAD_LEN"]

# float32 payload slots (the device builds them in server.tap_payload)
_ETA, _NAIVE, _TARGET, _METRIC, _CLIP, _PART, _REAL, _DROP, _STRAG, _CORR, \
    _FAULT_T, _SIGMA = range(12)
PAYLOAD_LEN = 12

_ACTIVE: "TapSession | None" = None


class TapSession:
    """One tracked run's host tap: payloads in, tracker events out."""

    def __init__(self, tracker, *, start_round: int = 0, ledger_fn=None,
                 faults_active: bool = False, bytes_per_round: float | None = None,
                 shard: int = 0):
        self.tracker = tracker
        self.shard = int(shard)     # the rank on the client mesh; only shard 0 reports
        self.expected_t = int(start_round)
        self.ledger_fn = ledger_fn
        self.faults_active = faults_active
        # the modeled communication of a round, 4 * comm_floats(d): static
        # for a spec, added on the host to every executed round's event
        self.bytes_per_round = None if bytes_per_round is None else float(bytes_per_round)
        # rounds actually run (rolled-back ones included); a resume starts at
        # the checkpoint's round so that the ledger counts from round 0
        self.executed = int(start_round)
        self.buffer: dict[int, tuple[np.ndarray, float | None]] = {}
        self._t0 = time.perf_counter()

    # -- engine-facing ----------------------------------------------------------
    def emit(self, t: int, vec, round_time_s: float | None = None) -> None:
        """Round ``t``'s payload (any order; delivered in round order)."""
        if self.shard != 0:
            return
        self.buffer[int(t)] = (np.asarray(vec, dtype=np.float32), round_time_s)
        while self.expected_t in self.buffer:
            v, dt = self.buffer.pop(self.expected_t)
            self._deliver(self.expected_t, v, dt)
            self.expected_t += 1

    # -- loop-facing (rollbacks and profile windows of the session's run loop) --
    def rollback(self, to_round: int, fault_round: int, attempt: int) -> None:
        """A watchdog rollback to ``to_round``: the rounds from there deliver again."""
        self.buffer.clear()
        self.expected_t = int(to_round)
        self._t0 = time.perf_counter()
        if self.shard != 0:
            return
        self.tracker.log(int(fault_round), {"event": "rollback", "to_round": int(to_round),
                                            "attempt": int(attempt)})

    def profile_event(self, action: str, round_: int, trace_dir: str) -> None:
        """A profile window's start or stop."""
        if self.shard != 0:
            return
        self.tracker.log(int(round_), {"event": f"profile_{action}", "trace_dir": trace_dir})

    # -- internals ------------------------------------------------------------
    def _deliver(self, t: int, v: np.ndarray, dt: float | None) -> None:
        now = time.perf_counter()
        if dt is None:
            dt = now - self._t0
        self._t0 = now
        ft = int(v[_FAULT_T]) if math.isfinite(float(v[_FAULT_T])) else -1
        frozen = ft >= 0 and t > ft
        event = {"round_time_s": float(dt)}
        if frozen:
            # the watchdog froze the carry at fault_t; this round did not run
            event["frozen"] = True
            event["watchdog_fault_round"] = ft
            self.tracker.log(t, event)
            return
        self.executed += 1
        event.update(eta=float(v[_ETA]), eta_naive=float(v[_NAIVE]),
                     eta_target=float(v[_TARGET]))
        if self.bytes_per_round is not None:
            event["bytes_per_round"] = self.bytes_per_round
        if math.isfinite(float(v[_METRIC])):
            event["metric"] = float(v[_METRIC])
        if math.isfinite(float(v[_CLIP])):
            event["clip"] = float(v[_CLIP])
        if math.isfinite(float(v[_SIGMA])):
            # the round's noise std: sigma(t) of a schedule, a fixed sigma;
            # omitted where the cohort shares none (NaN)
            event["sigma"] = float(v[_SIGMA])
        event["participants"] = int(v[_PART])
        if self.faults_active:
            event.update(realized_clients=int(v[_REAL]), dropped=int(v[_DROP]),
                         stragglers=int(v[_STRAG]), corrupt=int(v[_CORR]))
        if ft >= 0:
            event["watchdog_fault_round"] = ft
        if self.ledger_fn is not None:
            # observability must never kill a run
            try:
                rep = self.ledger_fn(self.executed)
            except Exception as e:  # noqa: BLE001 - deliberate firewall
                event["ledger_error"] = repr(e)
                self.ledger_fn = None
            else:
                event.update(ledger_rounds=self.executed, mu=float(rep.mu),
                             eps=float(rep.eps_numerical), eps_rdp=float(rep.eps_rdp))
        self.tracker.log(t, event)


def install(session: TapSession) -> None:
    """Make ``session`` the active tap (one at a time)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a telemetry TapSession is already active; "
                           "sessions may not run concurrently in-process")
    _ACTIVE = session


def uninstall() -> None:
    """Detach the active tap."""
    global _ACTIVE
    _ACTIVE = None


def active() -> "TapSession | None":
    """The active tap, or None (the JAX package's accessor; the port's round
    loop gets its tap passed in and does not call it)."""
    return _ACTIVE
