"""Per-round fault injection and the degradation helpers (counterpart of
repro/fedsim/faults.py).

Clients drop out, stragglers miss the deadline with part of their local
training done, and devices return corrupted (non-finite) updates.
``FaultSpec`` declares the fault model; this module owns the draws and the
degradation that the round loop applies.

* **Draws.**  Each fault class draws from a CPU generator of its own,
  seeded by ``SeedSequence([round seed, FAULT_TAG, class])``; the round seed
  is the round generator's (``round_generator(seed, t).initial_seed()``), a
  function of (run seed, t).  Every vector is drawn for the whole cohort and
  indexed by global client index, on the host.  A class that is off draws
  nothing, and no class touches the round generator, so adding faults never
  shifts the cohort mask or the noise of the round; a resumed run redraws
  the same faults.  The round takes the drawn ``(alive, straggler,
  corrupt)`` tensors as inputs, so tests can feed it the JAX package's own.

* **Degradation.**  A failed client becomes a zero-weight row of the
  masked-moment protocol: the effective mask is the product of the
  sampling mask, the dropout survival mask and a finite screen on the
  device (``finite_rows``) that catches injected NaN rows and clients that
  diverged alike.  Rows are zeroed with ``where`` at the source
  (``mask_rows``), never multiplied, so a NaN cannot reach a sum as
  ``0 * nan``; the round's clamped count makes an all-failed round a zero
  update, never NaN.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.fedsim.local import mask_rows
from repro_torch.fedsim.specs import FAULT_TAG, FaultSpec

__all__ = [
    "fault_masks",
    "gather_fault_rows",
    "resolve_steps",
    "inject_corruption",
    "finite_rows",
    "apply_faults",
    "sanitize_moments",
]

# one generator per fault class under the round's FAULT_TAG
_DROPOUT_SUB, _STRAGGLER_SUB, _CORRUPT_SUB = 0, 1, 2


def fault_masks(fault: FaultSpec, round_seed: int, num_clients: int):
    """One round's fault draws for the whole cohort, on the host.

    ``round_seed`` is the round generator's seed (``gen.initial_seed()``).
    Returns ``(alive, straggler, corrupt)``, each a (num_clients,) float32
    {0, 1} tensor, or None where that class is off.  Position i is global
    client i.
    """
    def draw(sub: int, rate: float):
        """Bernoulli(rate) over the cohort from class ``sub``'s generator."""
        if rate <= 0.0:
            return None
        state = np.random.SeedSequence([int(round_seed), FAULT_TAG, sub]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device="cpu").manual_seed(int(state))
        return (torch.rand(num_clients, generator=gen) < rate).to(torch.float32)

    dropped = draw(_DROPOUT_SUB, fault.dropout)
    alive = None if dropped is None else 1.0 - dropped
    return alive, draw(_STRAGGLER_SUB, fault.straggler), draw(_CORRUPT_SUB, fault.corrupt)


def gather_fault_rows(slots: torch.Tensor, *vectors):
    """Each (M,) fault vector's rows at a gathered block's ``slots`` (host
    tensors); None passes through.  Padding slots read client 0's draw,
    which their zero slot mask keeps out of every sum."""
    return tuple(None if v is None else v.index_select(0, slots) for v in vectors)


def resolve_steps(fault: FaultSpec, straggler: torch.Tensor, tau: int) -> torch.Tensor:
    """Per-client local step counts (int32, on ``straggler``'s device):
    ``straggler_steps`` for a straggler, capped at tau (a straggler never
    trains more), else ``tau``."""
    cut = min(int(fault.straggler_steps), int(tau))
    return torch.where(straggler > 0, cut, int(tau)).to(torch.int32)


def inject_corruption(deltas: torch.Tensor, corrupt: torch.Tensor) -> torch.Tensor:
    """The flagged rows of an (m, d) update block replaced by NaN: the
    update a corrupted device returns, which the finite screen must catch."""
    return torch.where((corrupt > 0)[:, None], float("nan"), deltas)


def finite_rows(deltas: torch.Tensor) -> torch.Tensor:
    """(m,) float32 {0, 1} finite screen: 1 where every coordinate of the
    row is finite."""
    return torch.isfinite(deltas).all(dim=-1).to(torch.float32)


def apply_faults(deltas: torch.Tensor, mask: torch.Tensor, alive: torch.Tensor | None,
                 corrupt: torch.Tensor | None):
    """One round's faults on a block of update rows.

    ``mask`` is the block's participation mask; ``alive`` / ``corrupt`` its
    rows of the round's draws (None where the class is off), on ``deltas``'
    device.  Returns ``(deltas, eff_mask)``: failed rows zeroed with
    ``where``, and the effective mask carrying the realized participation,
    the count every normalization downstream uses.  Every returned row is
    finite, and a row is on in ``eff_mask`` only where it was on in ``mask``,
    alive, not corrupted and finite.
    """
    if corrupt is not None:
        deltas = inject_corruption(deltas, corrupt)
    eff = mask if alive is None else mask * alive
    # the finite screen runs whenever faults are injected: corruption is the
    # planted cause, but a client that diverged degrades the same way
    eff = eff * finite_rows(deltas)
    return mask_rows(deltas, eff), eff


def sanitize_moments(moments):
    """Every non-finite floating value of a round's moments (a
    ``RoundMoments``, dicts and tuples of them and of tensors) set to 0, on
    the device: an Inf that survived the clip or an overflowed square cannot
    reach the FedEXP ratio or a carry.  Finite moments pass unchanged."""
    if isinstance(moments, torch.Tensor):
        if not moments.is_floating_point():
            return moments
        return torch.where(torch.isfinite(moments), moments, torch.zeros_like(moments))
    if isinstance(moments, float):
        return moments if math.isfinite(moments) else 0.0
    if isinstance(moments, dict):
        return {k: sanitize_moments(v) for k, v in moments.items()}
    if isinstance(moments, (tuple, list)):
        return type(moments)(sanitize_moments(v) for v in moments)
    if dataclasses.is_dataclass(moments):
        return dataclasses.replace(moments, **{
            f.name: sanitize_moments(getattr(moments, f.name))
            for f in dataclasses.fields(moments)})
    return moments
