"""Checkpoints: a tree of tensors saved to and restored from ``.npz``
(counterpart of repro/checkpoint/__init__.py, the same kind of file).

A checkpoint is ``<dir>/ckpt_<step:08d>.npz``, its leaves keyed by their
``/``-joined tree path, and a JSON sidecar ``ckpt_<step:08d>.json`` with the
step, the archive's sha256 and the caller's extras.  Paths are the JAX
package's: dict keys, sequence indices, and dataclass or NamedTuple fields
by name, so ``AdaptiveClipState.clip`` and ``ScaffoldState.c`` / ``c_is``
are keyed alike in both packages, and either package loads the other's
files.  The archive is written to a tmp file, the sidecar next, and the
archive renamed last: a step becomes visible (``latest_step`` lists
archives) only once both halves are written.

Every unreadable half (a truncated archive, garbage bytes, mangled JSON, a
sha256 mismatch) is a ``ValueError`` naming the file.  ``load_checkpoint``
retries a transient ``OSError`` with linear backoff; ``load_latest_intact``
walks the steps newest first past corrupt ones to the newest that loads,
the rollback target of a recovering run.  Restored leaves take the
template leaf's dtype and device: state lives on the card except while it
is saved.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from typing import Any

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_latest_intact",
    "latest_step",
    "checkpoint_steps",
]

_SEP = "/"


def _children(node):
    """``[(key, child)]`` of a container node, or None for a leaf.  None is
    an empty subtree, as in JAX."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):       # NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaves_with_path(tree, prefix: str = ""):
    """``[(path, leaf)]`` of ``tree`` in order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _leaves_with_path(child, f"{prefix}{_SEP}{key}" if prefix else key)
    return out


def _rebuild(tree, leaves):
    """``tree`` with its leaves taken in order from the iterator ``leaves``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for _, v in kids))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for _, v in kids)
    return dataclasses.replace(tree, **{k: _rebuild(v, leaves) for k, v in kids})


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _leaves_with_path(tree)}


def _sidecar(path: str) -> str:
    return path[:-len(".npz")] + ".json"


def _atomic_json_dump(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(directory: str, step: int, params, extra: dict | None = None) -> str:
    """Write ``<dir>/ckpt_<step>.npz`` and its sidecar; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    # archive to a tmp file (its sha256 rides the sidecar), sidecar second,
    # archive renamed last: a crash between the writes leaves an orphan
    # sidecar or tmp file, never a latest step that cannot be loaded
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(params))
    meta = {"step": step, "npz_sha256": _sha256(tmp), **(extra or {})}
    _atomic_json_dump(meta, _sidecar(path))
    os.replace(tmp, path)
    return path


def _read_meta(path: str) -> dict:
    """The sidecar as a dict; mangled JSON is a corrupt checkpoint."""
    meta_path = _sidecar(path)
    try:
        with open(meta_path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as exc:
        raise ValueError(f"corrupt checkpoint sidecar {meta_path}: {exc}") from exc


def _restore_leaf(arr: np.ndarray, leaf):
    """``arr`` as the template ``leaf`` holds it: a tensor of its dtype on its
    device, an array of its dtype, or the array itself."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(leaf.device, leaf.dtype)
    return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr


def _load_once(directory: str, template, step: int):
    """One load attempt; every corruption is a ValueError."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    meta = _read_meta(path)
    recorded = meta.get("npz_sha256")
    if recorded is not None and _sha256(path) != recorded:
        raise ValueError(
            f"corrupt checkpoint {path}: sha256 mismatch with sidecar "
            "(truncated or modified archive)")
    try:
        data = np.load(path, allow_pickle=False)
    except FileNotFoundError:
        raise
    except Exception as exc:  # zipfile.BadZipFile, OSError on garbage, ...
        raise ValueError(f"corrupt checkpoint {path}: {exc}") from exc
    leaves = []
    for key, leaf in _leaves_with_path(template):
        if key not in data:
            raise ValueError(
                f"checkpoint {path} is missing leaf {key!r} required by the "
                f"template (have: {sorted(data.files)[:10]}...)")
        try:
            arr = data[key]
        except Exception as exc:  # a truncated member of an archive without a sha
            raise ValueError(
                f"corrupt checkpoint {path}: leaf {key!r} unreadable: {exc}") from exc
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape}, template "
                f"expects {tuple(np.shape(leaf))}; checkpoint and session "
                "configuration (model dim, avg_last, optimizer) must match")
        leaves.append(_restore_leaf(arr, leaf))
    return _rebuild(template, iter(leaves)), meta


def load_checkpoint(directory: str, template, step: int | None = None,
                    retries: int = 0, backoff: float = 0.0):
    """Restore into the structure of ``template``; returns ``(params, meta)``.

    ``retries`` re-attempts the read after a transient ``OSError``, sleeping
    ``backoff * attempt`` seconds between tries.  A missing checkpoint
    (FileNotFoundError) and a corrupt one (ValueError) are never retried.
    """
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    for attempt in range(max(0, int(retries)) + 1):
        try:
            return _load_once(directory, template, step)
        except (FileNotFoundError, ValueError):
            raise
        except OSError:
            if attempt >= retries:
                raise
            if backoff > 0.0:
                time.sleep(backoff * (attempt + 1))


def load_latest_intact(directory: str, template, retries: int = 0, backoff: float = 0.0):
    """The newest checkpoint that loads: ``(step, params, meta)``.

    Walks the steps newest first and skips a corrupt or unreadable one.
    ``template`` is a tree or a callable ``step -> tree`` (where shapes
    depend on the step, as per-round histories do).  Raises
    ``FileNotFoundError`` when the directory holds no checkpoint, and
    ``ValueError`` listing every step's failure when none is intact.
    """
    steps = sorted(checkpoint_steps(directory), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    failures = []
    for step in steps:
        tpl = template(step) if callable(template) else template
        try:
            params, meta = load_checkpoint(directory, tpl, step=step, retries=retries,
                                           backoff=backoff)
            return step, params, meta
        except (ValueError, OSError) as exc:
            failures.append(f"step {step}: {exc}")
    raise ValueError(f"no intact checkpoint in {directory}; " + "; ".join(failures))


def checkpoint_steps(directory: str) -> list[int]:
    """Every visible checkpoint step, ascending ([] when none)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.match(r"ckpt_(\d+)\.npz$", f)))


def latest_step(directory: str) -> int | None:
    """The newest visible checkpoint step, or None."""
    steps = checkpoint_steps(directory)
    return max(steps) if steps else None
