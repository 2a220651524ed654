"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises.

    The port runs on the card unless the caller asks for the CPU: there is no
    silent fallback.  ``"meta"`` (shapes and dtypes, no storage) is what the
    dry-run (``launch/dryrun.py``) builds its models and steps on.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu' (or 'meta', shapes only), got "
                         f"{device!r}")
    return dev
