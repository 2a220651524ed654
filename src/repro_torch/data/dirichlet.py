"""Label-Dirichlet federated partitioner (Hsu, Qi, Brown 2019); counterpart
of repro/data/dirichlet.py.

For each client, class proportions p_i ~ Dir(alpha * 1_K); samples are drawn
to match.  alpha = 0.3 (the paper's setting) gives strongly non-IID clients.
The draws are numpy's ``default_rng(seed)`` in the JAX package's order, so
one seed gives the JAX package's indices exactly.  Clients get fixed-size
padded batches (a mask-weighted loss), so the cohort vmaps.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dirichlet_partition", "client_image_batches"]


def dirichlet_partition(seed: int, labels, num_clients: int, alpha: float = 0.3,
                        samples_per_client: int | None = None) -> dict:
    """Partition sample indices across clients with Dir(alpha) label skew.

    ``labels`` is a numpy array or a tensor (read on the host).  Returns
    ``{"idx": (M, n) int32, "mask": (M, n) float32}`` tensors on the host:
    the sample indices and their validity mask (padding repeats a valid
    index with mask 0).
    """
    rng = np.random.default_rng(seed)
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    num_classes = int(labels.max()) + 1
    per_client = samples_per_client or max(1, len(labels) // num_clients)

    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    idx = np.zeros((num_clients, per_client), np.int32)
    mask = np.ones((num_clients, per_client), np.float32)

    props = rng.dirichlet(alpha * np.ones(num_classes), size=num_clients)
    for i in range(num_clients):
        counts = rng.multinomial(per_client, props[i])
        chosen: list[np.ndarray] = []
        for c, k in enumerate(counts):
            if k == 0:
                continue
            pool = by_class[c]
            chosen.append(rng.choice(pool, size=k, replace=k > len(pool)))
        flat = np.concatenate(chosen) if chosen else np.array([0], np.int64)
        if len(flat) < per_client:  # defensive; multinomial sums to per_client
            flat = np.pad(flat, (0, per_client - len(flat)), mode="edge")
            mask[i, len(flat):] = 0.0
        idx[i] = flat[:per_client]
    return {"idx": torch.from_numpy(idx), "mask": torch.from_numpy(mask)}


def client_image_batches(dataset, part: dict) -> dict:
    """Per-client padded batches of a partition, on the dataset's device:
    ``{"x": (M, n, 28, 28, 1), "y": (M, n) int32, "mask": (M, n)}``."""
    idx = part["idx"].to(dataset.train_x.device, torch.int64)
    return {"x": dataset.train_x[idx], "y": dataset.train_y[idx],
            "mask": part["mask"].to(dataset.train_x.device)}
