"""Stateless-resumable synthetic token pipeline (counterpart of
``repro.data.pipeline``), one host.

Batch content is a pure function of (seed, step, host): restarting from
a checkpoint at step s resumes the exact stream. Each batch comes from
its own ``torch.Generator`` seeded from the three, on the device asked
for; the bits differ from the reference's ``jax.random`` stream. A host
takes its ``global_batch / num_hosts`` rows; the data-parallel trainer
runs its workers in one process and splits host 0's global batch.
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
    num_hosts: int = 1


def host_batch(cfg: PipelineConfig, step: int, host: int = 0, device="cpu"):
    """(tokens, labels), each (global_batch / num_hosts, seq_len), for
    this host at this step."""
    if cfg.global_batch % cfg.num_hosts or not 0 <= host < cfg.num_hosts:
        raise ValueError(f"host {host} of {cfg.num_hosts} cannot split a "
                         f"global batch of {cfg.global_batch}")
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.seed * 1_000_003 + step + host * 2**40) % 2**63)
    return lm_batch(gen, cfg.global_batch // cfg.num_hosts, cfg.seq_len,
                    cfg.vocab)
