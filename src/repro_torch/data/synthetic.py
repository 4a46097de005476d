"""Deterministic synthetic data (counterpart of ``repro.data.synthetic``).

LM tokens: uniform draws with a repeated 8-token motif spliced into every
third position, so next-token prediction has learnable structure.
Classification: K class prototypes plus Gaussian noise at the original
input dims, linearly separable at a margin set by the noise. Draws come
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
