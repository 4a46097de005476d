"""Deterministic synthetic classification data (counterpart of
``repro.data.synthetic``): K class prototypes plus Gaussian noise at the
original input dims, linearly separable at a margin set by the noise.
Draws come from a ``torch.Generator`` and are made on its device; the
bits differ from ``jax.random``.
"""
from __future__ import annotations

import torch


def class_prototypes(gen: torch.Generator, num_classes: int,
                     dim: int) -> torch.Tensor:
    return torch.randn((num_classes, dim), generator=gen,
                       device=gen.device) / dim ** 0.25


def classification_batch(gen: torch.Generator, protos: torch.Tensor,
                         batch: int, noise: float = 1.0):
    """(x (B, dim), y (B,)): prototype + Gaussian noise."""
    y = torch.randint(0, protos.shape[0], (batch,), generator=gen,
                      device=gen.device)
    x = protos[y] + noise * torch.randn((batch, protos.shape[1]),
                                        generator=gen, device=gen.device)
    return x, y
