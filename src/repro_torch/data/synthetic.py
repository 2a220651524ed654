"""Synthetic heterogeneous linear-regression dataset (paper §5 / Appendix E.1).

Counterpart of repro/data/synthetic.py.  Generation (verbatim from E.1):

    w* ~ N(0, I_d)                       shared optimum across clients
    u_i ~ N(0, 0.1)                      per-client heterogeneity level
    m_i ~ N(u_i, 1)                      per-client feature mean (scalar)
    x_i ~ N(m_i * 1, I_d)                client i's feature vector
    y_i = x_i^T w*
    f_i(w) = (x_i^T w - y_i)^2

The draws come from a ``torch.Generator`` and so differ from the JAX
package's; the parity tests feed both packages the JAX generator's arrays.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SyntheticLinReg", "make_synthetic_linreg", "linreg_loss", "distance_to_opt"]


@dataclasses.dataclass
class SyntheticLinReg:
    """One draw of the E.1 dataset: features, targets and the shared optimum."""

    x: torch.Tensor        # (M, d)
    y: torch.Tensor        # (M,)
    w_star: torch.Tensor   # (d,)

    @property
    def num_clients(self) -> int:
        """M, one data point per client."""
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        """d, the model dimension."""
        return self.x.shape[1]

    def client_batches(self):
        """The per-client data as the session takes it: ``{"x": (M, d), "y": (M,)}``."""
        return {"x": self.x, "y": self.y}


def make_synthetic_linreg(generator: torch.Generator, num_clients: int, dim: int,
                          *, unit_features: bool = True) -> SyntheticLinReg:
    """Paper E.1 generation on the generator's device; ``unit_features``
    normalizes each x_i to unit L2 (the JAX package's deviation, DESIGN.md §7)."""
    kw = dict(generator=generator, device=generator.device)
    w_star = torch.randn(dim, **kw)
    u = (0.1 ** 0.5) * torch.randn(num_clients, **kw)
    m = u + torch.randn(num_clients, **kw)
    x = m[:, None] + torch.randn(num_clients, dim, **kw)
    if unit_features:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return SyntheticLinReg(x=x, y=x @ w_star, w_star=w_star)


def linreg_loss(w: torch.Tensor, batch) -> torch.Tensor:
    """f_i(w) = (x_i^T w - y_i)^2 for one client."""
    resid = torch.dot(batch["x"], w) - batch["y"]
    return resid * resid


def distance_to_opt(w_star: torch.Tensor):
    """Eval closure: ||w - w*|| (Fig. 1 left metric)."""

    def fn(w):
        return torch.linalg.vector_norm(w - w_star)

    return fn
