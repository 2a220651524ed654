"""Client data sources: cohorts kept on the host, on disk or generated
(counterpart of repro/fedsim/data.py).

Client data handed to a session as tensors or arrays moves to the card
whole, which bounds the cohort size M by device memory.  A
``ClientDataSource`` serves the rows of clients by global index from
wherever they live: numpy arrays in host memory, an ``.npz`` archive on
disk, or a function that generates them.  The streaming engine
(``EngineSpec(engine="stream")``) fetches one chunk of clients at a time and
copies it to the card, ``DataSpec.prefetch`` chunks ahead of the chunk being
trained, so M is bounded by host storage, or by nothing for generated data.

Contract.  A source provides:

    num_clients   the cohort size M
    kind          "device" | "host" | "npz" | "synthetic" (the session's
                  ``DataSpec.kind``)
    fetch(idx)    the rows of the global client indices ``idx`` (a 1-D numpy
                  int array, in any order, with repeats: a gathered round
                  fetches by slot), as a tree (dicts, lists, tuples) of numpy
                  arrays with len(idx) rows

``fetch`` is deterministic: the same indices give the same rows on every
call, which makes a run on a source reproducible and its checkpoints
resumable bit for bit.

``ArraySource`` wraps data that may as well live on the card: the session
unwraps it and runs the device-resident path, bit for bit what the bare
tensors give.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ClientDataSource", "ArraySource", "HostArraySource", "NpzSource", "SyntheticSource",
           "as_data_source"]


def _to_numpy(x) -> np.ndarray:
    """A leaf as a numpy array (a tensor is read to the host)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leading_dim(tree) -> int:
    """The client count of a tree of per-client leaves (leading axis)."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("client batches have no array leaves")
    m = leaves[0].shape[0]
    for x in leaves:
        if x.shape[0] != m:
            raise ValueError("every client-batch leaf needs the same leading (client) "
                             f"dimension; got {x.shape[0]} vs {m}")
    return int(m)


class ClientDataSource:
    """Base class of index-addressable client data (the module's contract)."""

    kind: str = "host"

    @property
    def num_clients(self) -> int:
        """The cohort size M."""
        raise NotImplementedError

    def fetch(self, idx: np.ndarray):
        """The rows of global client indices ``idx`` (a tree of numpy arrays)."""
        raise NotImplementedError


class ArraySource(ClientDataSource):
    """Device-resident data behind the source interface.

    The session unwraps ``.batches`` and runs the device-resident path, so a
    run on it is bit for bit the run on the bare data.  ``fetch`` still
    serves rows (read to the host), so code written against the contract
    runs on it too."""

    kind = "device"

    def __init__(self, batches):
        self.batches = batches
        self._m = _leading_dim(batches)

    @property
    def num_clients(self) -> int:
        """The cohort size M."""
        return self._m

    def fetch(self, idx: np.ndarray):
        """The rows of global client indices ``idx`` (a tree of numpy arrays)."""
        idx = np.asarray(idx)
        return tree_map(lambda x: _to_numpy(x)[idx], self.batches)


class HostArraySource(ClientDataSource):
    """Numpy arrays in host memory: the cohort never lies on the card whole;
    ``fetch`` copies the rows asked for."""

    kind = "host"

    def __init__(self, batches):
        self.batches = tree_map(_to_numpy, batches)
        self._m = _leading_dim(self.batches)

    @property
    def num_clients(self) -> int:
        """The cohort size M."""
        return self._m

    def fetch(self, idx: np.ndarray):
        """The rows of global client indices ``idx`` (a tree of numpy arrays)."""
        idx = np.asarray(idx)
        return tree_map(lambda x: x[idx], self.batches)


class NpzSource(ClientDataSource):
    """An ``.npz`` archive on disk, one member per client-batch leaf, client
    axis leading.

    Members load on first use and stay cached, so opening the archive costs
    nothing and host memory holds only the members fetched.  The rows come
    as a flat dict of the member names: ``np.savez(path, x=..., y=...)``
    gives ``{"x": ..., "y": ...}`` batches."""

    kind = "npz"

    def __init__(self, path: str):
        self.path = str(path)
        self._npz = np.load(self.path)
        self._cache: dict[str, np.ndarray] = {}
        if not self._npz.files:
            raise ValueError(f"{path!r} holds no arrays")
        self._m = int(self._npz[self._npz.files[0]].shape[0])

    @property
    def num_clients(self) -> int:
        """The cohort size M."""
        return self._m

    def _leaf(self, name: str) -> np.ndarray:
        if name not in self._cache:
            self._cache[name] = self._npz[name]
        return self._cache[name]

    def fetch(self, idx: np.ndarray):
        """The rows of global client indices ``idx`` (a dict of numpy arrays)."""
        idx = np.asarray(idx)
        return {name: self._leaf(name)[idx] for name in self._npz.files}


class SyntheticSource(ClientDataSource):
    """Generated client data: ``fn(idx)`` returns the rows as a tree of
    numpy arrays.

    Nothing is stored.  ``fn`` must be a pure function of the indices (any
    randomness derived from them), so that fetches repeat and a resumed run
    sees the same data."""

    kind = "synthetic"

    def __init__(self, fn: Callable[[np.ndarray], Any], num_clients: int):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self._fn = fn
        self._m = int(num_clients)

    @property
    def num_clients(self) -> int:
        """The cohort size M."""
        return self._m

    def fetch(self, idx: np.ndarray):
        """The rows of global client indices ``idx`` (a tree of numpy arrays)."""
        return self._fn(np.asarray(idx))


def as_data_source(batches) -> ClientDataSource | None:
    """A ``ClientDataSource`` as it is; anything else (tensors, arrays, trees
    of them) None: the device-resident path."""
    return batches if isinstance(batches, ClientDataSource) else None
