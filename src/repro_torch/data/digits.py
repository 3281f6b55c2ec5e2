"""Deterministic synthetic 20x20 digit dataset (MNIST stand-in).

10 smooth class prototypes + per-sample shifts and pixel noise, drawn
from a numpy generator seeded by `seed`, so a seed gives the same data on
every device. The draws differ from the reference package's (which uses
jax.random); the dataset plays the same role.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

IMG = 20
N_CLASSES = 10


def _prototypes(rng: np.random.Generator) -> np.ndarray:
    """Ten smooth, well-separated 20x20 prototypes in [0, 1]."""
    s = rng.standard_normal((N_CLASSES, IMG, IMG))
    k = np.ones(5) / 5.0

    def blur(img):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
        return np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 2, img)

    for _ in range(3):
        s = blur(s)
    lo = s.min(axis=(1, 2), keepdims=True)
    hi = s.max(axis=(1, 2), keepdims=True)
    return (s - lo) / (hi - lo)


def make_digits(
    n_samples: int,
    *,
    seed: int = 0,
    noise: float = 0.25,
    max_shift: int = 2,
    device: "str | torch.device | None" = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate (x, y): x (n, 400) float32 in [0,1], y (n,) int64 labels.

    `device` None means the GPU.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng)
    y = rng.integers(0, N_CLASSES, size=n_samples)
    shifts = rng.integers(-max_shift, max_shift + 1, size=(n_samples, 2))
    imgs = np.stack(
        [np.roll(protos[c], (int(s0), int(s1)), axis=(0, 1)) for c, (s0, s1) in zip(y, shifts)]
    )
    imgs = imgs + noise * rng.standard_normal(imgs.shape)
    imgs = np.clip(imgs, 0.0, 1.0)
    x = torch.as_tensor(imgs.reshape(n_samples, IMG * IMG), dtype=torch.float32)
    return x.to(dev), torch.as_tensor(y, dtype=torch.long).to(dev)


def train_test_split(
    n_train: int, n_test: int, *, seed: int = 0, **kw
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    x, y = make_digits(n_train + n_test, seed=seed, **kw)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]
