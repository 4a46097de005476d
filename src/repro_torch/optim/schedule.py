"""LR schedules (counterpart of ``repro.optim.schedule``): functions of
the host step count, computed in float32 as the reference computes
them."""
from __future__ import annotations

import numpy as np


def warmup_cosine(step: int, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    """Linear warmup to 1, then a cosine decay to ``min_ratio``."""
    f = np.float32
    s = f(step)
    if s < warmup_steps:
        return float(s / f(max(warmup_steps, 1)))
    t = (s - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
    t = np.clip(t, f(0.0), f(1.0))
    return float(f(min_ratio) + f(1 - min_ratio) * f(0.5)
                 * (f(1.0) + np.cos(f(np.pi) * t)))


def constant(step: int) -> float:
    return 1.0
