"""The paper's MNIST CNNs (Appendix E, Table 3) as flat-parameter models;
counterpart of repro/models/cnn.py.

CDP model:  conv(4 filters, 4x4) -> conv(8, 4x4) -> FC 128->32 -> ReLU -> FC 32->10
LDP model:  conv(2, 4x4) -> conv(1, 4x4) -> FC 16->10

Strides 2 then 3 (VALID), so that the flatten widths equal the stated FC
fan-ins (28 -> 13 -> 4); ReLU after each conv; softmax folded into the
cross-entropy (the JAX package's reading of the paper).  d = 5,046 (CDP) and
237 (LDP).

The parameters keep the JAX package's names and layouts: conv weights HWIO,
FC weights (in, out), activations NHWC; the flatten before the FCs is in
NHWC order, as the JAX package's, so the rows of ``f1_w`` / ``out_w`` meet
the features they were made for.

Each convolution is a gather of its input's patches in (kh, kw, C) order and
one product with the HWIO weight reshaped to (kh kw C, O), in NHWC
throughout.  Under ``torch.func.vmap`` each client's weights differ from the
first local step on: the products become batched matrix products and the
gathers batched gathers, one program for the cohort.  ``conv2d``'s batching
rule would fold the clients into the channel axis as a grouped convolution,
whose backward cuDNN runs as one weight-gradient and one data-gradient
kernel per group (per client) for the CDP CNN's 4 -> 8 convolution: 4000
kernels a step at M = 1000 (``tools/e2_cnn_conv.py`` times both forms on
the card; PERF.md §6).  The convolutions and products are plain PyTorch:
the JAX package's are ``jax.lax``/``jnp``, not Pallas kernels.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.fedsim.flat import flatten_model

__all__ = ["CNNModel", "make_cnn", "make_cnn_params", "masked_xent_loss", "pytree_xent_loss",
           "accuracy_fn", "pytree_accuracy_fn"]


@functools.lru_cache(maxsize=16)
def _patch_index(h: int, w: int, kh: int, kw: int, stride: int, device: torch.device):
    """``(index, ho, wo)``: the flat pixel index (row * w + column) of output
    pixel (i, j)'s patch element (a, b), row ``i * stride + a`` and column
    ``j * stride + b``, in (i, j, a, b) order.  Made once per shape and
    device: its few small operations are host time on every local step."""
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    rows = (torch.arange(ho, device=device) * stride)[:, None] + torch.arange(kh, device=device)
    cols = (torch.arange(wo, device=device) * stride)[:, None] + torch.arange(kw, device=device)
    index = rows[:, None, :, None] * w + cols[None, :, None, :]
    return index.reshape(-1), ho, wo


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """VALID conv of NHWC ``x`` by HWIO ``w``, plus ``b``: NHWC, as one
    gather of the (kh, kw, C) patches and one product with the weight."""
    kh, kw, c, o = w.shape
    n, h, wd = x.shape[:3]
    index, ho, wo = _patch_index(h, wd, kh, kw, stride, x.device)
    patches = x.reshape(n, h * wd, c)[:, index]
    return patches.reshape(n, ho, wo, kh * kw * c) @ w.reshape(kh * kw * c, o) + b


def _forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(n, 10) logits of NHWC images ``x``."""
    h = torch.relu(_conv(x, params["c1_w"], params["c1_b"], 2))
    h = torch.relu(_conv(h, params["c2_w"], params["c2_b"], 3))
    h = h.reshape(h.shape[0], -1)
    if "f1_w" in params:
        h = torch.relu(h @ params["f1_w"] + params["f1_b"])
    return h @ params["out_w"] + params["out_b"]


@dataclasses.dataclass
class CNNModel:
    """A CNN as one flat vector and the function that rebuilds its tree."""

    init_flat: torch.Tensor
    unravel: Callable
    dim: int

    def apply(self, w_flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x`` under the flat parameters ``w_flat``."""
        return _forward(self.unravel(w_flat), x)


def make_cnn_params(gen: torch.Generator, variant: str = "cdp") -> dict:
    """The parameter tree of the paper's CNNs on the generator's device: He
    normal conv and FC weights (std sqrt(2 / fan_in)), zero biases."""
    def he(shape, fan_in):
        return torch.randn(shape, generator=gen, device=gen.device) * math.sqrt(2.0 / fan_in)

    def zeros(n):
        return torch.zeros(n, device=gen.device)

    if variant == "cdp":
        return {"c1_w": he((4, 4, 1, 4), 16), "c1_b": zeros(4),
                "c2_w": he((4, 4, 4, 8), 64), "c2_b": zeros(8),
                "f1_w": he((128, 32), 128), "f1_b": zeros(32),
                "out_w": he((32, 10), 32), "out_b": zeros(10)}
    if variant == "ldp":
        return {"c1_w": he((4, 4, 1, 2), 16), "c1_b": zeros(2),
                "c2_w": he((4, 4, 2, 1), 32), "c2_b": zeros(1),
                "out_w": he((16, 10), 16), "out_b": zeros(10)}
    raise ValueError(f"unknown CNN variant {variant!r}")


def make_cnn(gen: torch.Generator, variant: str = "cdp") -> CNNModel:
    """variant: 'cdp' (4/8 filters and a hidden FC) or 'ldp' (2/1 filters)."""
    flat, unravel = flatten_model(make_cnn_params(gen, variant))
    return CNNModel(init_flat=flat, unravel=unravel, dim=flat.shape[0])


def _masked_xent(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Softmax cross-entropy, mean over the samples whose mask is set (all
    samples without a mask)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, batch["y"].to(torch.int64)[:, None], dim=-1)[:, 0]
    mask = batch.get("mask")
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def masked_xent_loss(model: CNNModel) -> Callable:
    """Client loss on the flat model: mask-weighted mean softmax xent."""
    def loss(w_flat, batch):
        return _masked_xent(model.apply(w_flat, batch["x"]), batch)

    return loss


def pytree_xent_loss() -> Callable:
    """Client loss on the parameter tree (``make_cnn_params``), for a session
    that takes the tree itself."""
    def loss(params, batch):
        return _masked_xent(_forward(params, batch["x"]), batch)

    return loss


def _accuracy(forward: Callable, x: torch.Tensor, y: torch.Tensor, chunk: int) -> torch.Tensor:
    """The fraction of ``x`` whose argmax logit is ``y``, ``chunk`` images at a
    time; a 0-d tensor on ``x``'s device (no host read)."""
    correct = sum(torch.sum(torch.argmax(forward(x[s:s + chunk]), dim=-1)
                            == y[s:s + chunk].to(torch.int64))
                  for s in range(0, x.shape[0], chunk))
    return correct / x.shape[0]


def accuracy_fn(model: CNNModel, x: torch.Tensor, y: torch.Tensor, chunk: int = 1000) -> Callable:
    """Eval closure on the flat model: test accuracy (Fig. 1 right metric)."""
    return lambda w_flat: _accuracy(lambda xs: model.apply(w_flat, xs), x, y, chunk)


def pytree_accuracy_fn(x: torch.Tensor, y: torch.Tensor, chunk: int = 1000) -> Callable:
    """``accuracy_fn`` for parameter trees (``make_cnn_params``)."""
    return lambda params: _accuracy(lambda xs: _forward(params, xs), x, y, chunk)
