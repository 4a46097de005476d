"""Deterministic synthetic data (counterpart of ``repro.data.synthetic``).

LM tokens: uniform draws with a repeated 8-token motif spliced into every
third position, so next-token prediction has learnable structure.
Classification: K class prototypes plus Gaussian noise at the original
input dims (784, or 32x32x3 images), linearly separable at a margin set
by the noise; the conv family's stand-in CIFAR batches use N(0, 1)
image prototypes and noise 0.5. PINN: collocation points on [0,1]^2. Draws come
from a ``torch.Generator`` and are made on its device; the bits differ
from ``jax.random``.
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


def image_batch(gen: torch.Generator, protos: torch.Tensor, batch: int,
                hw: int = 32, ch: int = 3, noise: float = 1.0):
    """(img (B, hw, hw, ch) NHWC, y (B,)) from hw*hw*ch-d prototypes."""
    x, y = classification_batch(gen, protos, batch, noise)
    return x.reshape(batch, hw, hw, ch), y


def cifar_prototypes(gen: torch.Generator, num_classes: int, hw: int = 32,
                     ch: int = 3) -> torch.Tensor:
    """(num_classes, hw, hw, ch) N(0, 1) image prototypes: the conv
    family's stand-in CIFAR classes (``repro.models.frontends.
    fake_cifar_batch``'s law), far stronger than ``class_prototypes``'
    dim^-1/4 scale."""
    return torch.randn((num_classes, hw, hw, ch), generator=gen,
                       device=gen.device)


def fake_cifar_batch(gen: torch.Generator, protos: torch.Tensor, batch: int,
                     noise: float = 0.5):
    """(img (B, hw, hw, ch) NHWC, y (B,)): a stand-in CIFAR batch, an
    image prototype (``cifar_prototypes``) plus Gaussian noise of std
    ``noise``, as the reference's ``fake_cifar_batch``. The batches are
    stationary, which the EMA sketches assume."""
    y = torch.randint(0, protos.shape[0], (batch,), generator=gen,
                      device=gen.device)
    x = protos[y] + noise * torch.randn((batch, *protos.shape[1:]),
                                        generator=gen, device=gen.device)
    return x, y


def pinn_points(gen: torch.Generator, n_interior: int, n_boundary: int):
    """(interior (n_interior, 2) uniform on [0,1]^2, boundary
    (n_boundary, 2) uniform on its four sides: y=0, y=1, x=0, x=1)."""
    dev = gen.device
    interior = torch.rand((n_interior, 2), generator=gen, device=dev)
    t = torch.rand((n_boundary,), generator=gen, device=dev)
    side = torch.randint(0, 4, (n_boundary,), generator=gen, device=dev)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    bx = torch.where(side < 2, t, torch.where(side == 2, zeros, ones))
    by = torch.where(side >= 2, t, torch.where(side == 0, zeros, ones))
    return interior, torch.stack([bx, by], dim=-1)


def lm_batch(gen: torch.Generator, batch: int, seq_len: int, vocab: int):
    """(tokens, labels), each (batch, seq_len) int64: the sequence and
    its shift by one."""
    dev = gen.device
    base = torch.randint(0, vocab, (batch, seq_len + 1), generator=gen,
                         device=dev)
    motif = torch.randint(0, vocab, (batch, 8), generator=gen, device=dev)
    reps = (seq_len + 1 + 7) // 8
    pattern = motif.repeat(1, reps)[:, : seq_len + 1]
    mix = torch.arange(seq_len + 1, device=dev) % 3 == 0
    seq = torch.where(mix[None, :], pattern, base)
    return seq[:, :-1], seq[:, 1:]
