"""Stateless-resumable synthetic token pipeline (counterpart of
``repro.data.pipeline``), one host.

Batch content is a pure function of (seed, step): restarting from a
checkpoint at step s resumes the exact stream. Each batch comes from its
own ``torch.Generator`` seeded from the two, on the device asked for;
the bits differ from the reference's ``jax.random`` stream. Sharding
the batch over hosts is ROADMAP A11.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.synthetic import lm_batch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seed: int
    global_batch: int
    seq_len: int
    vocab: int


def host_batch(cfg: PipelineConfig, step: int, device="cpu"):
    """(tokens, labels), each (global_batch, seq_len), at this step."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.seed * 1_000_003 + step) % 2**63)
    return lm_batch(gen, cfg.global_batch, cfg.seq_len, cfg.vocab)
