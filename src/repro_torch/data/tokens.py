"""Synthetic per-client token streams for federated LM training (the port's
counterpart of the stream in examples/train_federated_lm.py).

Each client draws tokens from its own Markov chain over the vocabulary: a
shared backbone of ``order_states`` transition rows mixed half and half with
client-specific rows, all Dirichlet, so client data is heterogeneous — the
regime DP-FedEXP targets.  The next token given the current one reads row
``token % order_states``.  Everything is drawn on the host from a
``torch.Generator`` (the JAX package draws from JAX keys: the same process,
not the same tokens).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MarkovStream", "make_client_stream"]


class MarkovStream:
    """Per-client Markov chains: ``cum`` (M, S, V) cumulative transition rows."""

    def __init__(self, cum: torch.Tensor):
        self.cum = cum
        self.num_clients, self.order_states, self.vocab = cum.shape

    def sample(self, generator: torch.Generator, tau: int, b: int, s: int) -> torch.Tensor:
        """(K, tau, b, s) int64 tokens, every chain starting from token 0: at
        every step one uniform per chain picks the first token whose
        cumulative probability reaches it."""
        k = self.num_clients
        state = torch.zeros((k, tau, b), dtype=torch.int64)
        rows = torch.arange(k)[:, None, None].expand(k, tau, b)
        out = torch.empty((k, tau, b, s), dtype=torch.int64)
        for t in range(s):
            u = torch.rand((k, tau, b), generator=generator)
            row = self.cum[rows, state % self.order_states]               # (K, tau, b, V)
            state = (row < u[..., None]).sum(dim=-1).clamp(max=self.vocab - 1)
            out[..., t] = state
        return out


def make_client_stream(generator: torch.Generator, num_clients: int, vocab: int, *,
                       order_states: int = 64) -> MarkovStream:
    """Shared backbone Dir(0.5) rows mixed half and half with client rows
    Dir(0.3), as the JAX package's example builds them.  The Dirichlet rows
    come from a numpy Generator seeded by one draw of ``generator``."""
    rng = np.random.default_rng(int(torch.randint(2**62, (), generator=generator)))
    base = rng.dirichlet(np.full(vocab, 0.5), size=order_states)
    biases = rng.dirichlet(np.full(vocab, 0.3), size=(num_clients, order_states))
    trans = torch.from_numpy(0.5 * base[None] + 0.5 * biases).float()
    return MarkovStream(torch.cumsum(trans, dim=-1))
