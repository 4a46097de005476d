"""Approximation-quality bounds, paper §4.5, Theorems 4.2 and 4.3
(counterpart of ``repro.core.bounds``)."""
from __future__ import annotations

import torch

SQRT6 = 6.0 ** 0.5


def tail_energy(a, r: int) -> torch.Tensor:
    """tau_{r+1}(A) = sqrt(sum_{i>r} sigma_i^2)."""
    s = torch.linalg.svdvals(a.float())
    return torch.sqrt(torch.sum(s[r:] ** 2))


def reconstruction_bound(a_ema, r: int) -> torch.Tensor:
    """Theorem 4.2: E||A_EMA - A~_EMA||_F <= sqrt(6) tau_{r+1}(A_EMA)."""
    return SQRT6 * tail_energy(a_ema, r)


def gradient_bound(delta, a_ema, r: int,
                   eps_coherence: float = 0.0) -> torch.Tensor:
    """Theorem 4.3: ||grad - grad^||_F <= ||delta^T||_2 [sqrt(6)
    tau_{r+1}(A_EMA) + O(eps_coherence)]."""
    dnorm = torch.linalg.matrix_norm(delta.float(), ord=2)
    return dnorm * (SQRT6 * tail_energy(a_ema, r) + eps_coherence)
