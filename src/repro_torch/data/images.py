"""Generated MNIST-like image classification dataset (counterpart of
repro/data/images.py).

No dataset can be downloaded, so the image experiment uses a generated 28x28
10-class set with MNIST-like statistics (the JAX package's deviation,
DESIGN.md §7).  Each class has a fixed smooth random template (a
low-frequency random field from a truncated 2-D Fourier synthesis); a sample
is its class's template under a small random shift, a random gain and
Gaussian pixel noise, clipped to [0, 1].

The draws come from a ``torch.Generator`` on its device (``draw_templates``,
``draw_split``) and so differ from the JAX package's; the arithmetic
(``smooth_random_field``, ``image_split``) takes the draws as inputs, so a
test feeds it the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ImageDataset", "make_image_dataset", "smooth_random_field", "image_split",
           "draw_templates", "draw_split"]

SIZE, CUTOFF, CLASSES = 28, 6, 10


@dataclasses.dataclass
class ImageDataset:
    """A train and a test split of the generated images."""

    train_x: torch.Tensor   # (N, 28, 28, 1) in [0, 1]
    train_y: torch.Tensor   # (N,) int32
    test_x: torch.Tensor
    test_y: torch.Tensor
    num_classes: int = CLASSES


def smooth_random_field(coef: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """(n, size, size) float32 low-frequency images from (n, c, c) complex64
    Fourier coefficients: ``size * Re ifft2`` of the coefficients in the
    low corner, each image shifted to minimum 0 and scaled to maximum 1."""
    n, c = coef.shape[0], coef.shape[1]
    spec = torch.zeros((n, size, size), dtype=torch.complex64, device=coef.device)
    spec[:, :c, :c] = coef
    img = torch.fft.ifft2(spec).real * size
    img = img - img.amin(dim=(1, 2), keepdim=True)
    return img / torch.clamp(img.amax(dim=(1, 2), keepdim=True), min=1e-6)


def image_split(templates: torch.Tensor, labels: torch.Tensor, shifts: torch.Tensor,
                gain: torch.Tensor, pixel_noise: torch.Tensor, noise: float = 0.15):
    """One split from its draws: ``(images (n, 28, 28, 1), labels (n,) int32)``.

    Sample i is template ``labels[i]`` rolled by ``shifts[i]`` (rows, then
    columns, as ``jnp.roll``), times ``gain[i]`` ((n, 1, 1)), plus ``noise *
    pixel_noise[i]`` ((n, 28, 28) standard normals), clipped to [0, 1]."""
    imgs = templates[labels.to(torch.int64)]
    size = imgs.shape[-1]
    ar = torch.arange(size, device=imgs.device)
    rows = (ar[None, :] - shifts[:, 0:1].to(torch.int64)) % size      # (n, 28)
    cols = (ar[None, :] - shifts[:, 1:2].to(torch.int64)) % size
    n_idx = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]
    imgs = imgs[n_idx, rows[:, :, None], cols[:, None, :]]
    imgs = torch.clamp(imgs * gain + noise * pixel_noise, 0.0, 1.0)
    return imgs[..., None], labels.to(torch.int32)


def draw_templates(gen: torch.Generator, n: int = CLASSES, cutoff: int = CUTOFF) -> torch.Tensor:
    """(n, cutoff, cutoff) complex64 coefficients with standard normal real
    and imaginary parts, on the generator's device."""
    kw = dict(generator=gen, device=gen.device)
    re = torch.randn(n, cutoff, cutoff, **kw)
    im = torch.randn(n, cutoff, cutoff, **kw)
    return torch.complex(re, im)


def draw_split(gen: torch.Generator, n: int, shift_px: int = 2, classes: int = CLASSES,
               size: int = SIZE) -> dict:
    """The draws of one split of n samples, on the generator's device:
    labels in [0, classes), shifts in [-shift_px, shift_px] (n, 2), gain in
    [0.8, 1.2) (n, 1, 1) and standard normal pixel noise (n, size, size)."""
    kw = dict(generator=gen, device=gen.device)
    return {"labels": torch.randint(0, classes, (n,), **kw),
            "shifts": torch.randint(-shift_px, shift_px + 1, (n, 2), **kw),
            "gain": 0.8 + 0.4 * torch.rand(n, 1, 1, **kw),
            "pixel_noise": torch.randn(n, size, size, **kw)}


def make_image_dataset(gen: torch.Generator, num_train: int = 12000, num_test: int = 2000,
                       noise: float = 0.15, shift_px: int = 2) -> ImageDataset:
    """The generated set on the generator's device: 10 class templates,
    then a train and a test split of them."""
    templates = smooth_random_field(draw_templates(gen))
    train_x, train_y = image_split(templates, **draw_split(gen, num_train, shift_px),
                                   noise=noise)
    test_x, test_y = image_split(templates, **draw_split(gen, num_test, shift_px), noise=noise)
    return ImageDataset(train_x=train_x, train_y=train_y, test_x=test_x, test_y=test_y)
