"""Static configuration of the EMA three-sketch framework, paper §4.1
(counterpart of ``repro.core.sketch``'s ``SketchConfig``).

Buffers are allocated at k_max = 2 r_max + 1 and the active rank is run
time state: columns >= k_active = 2 r + 1 are masked, so a rank change
alters values and never a shape.
"""
from __future__ import annotations

import dataclasses

import torch

PROJ_KINDS = ("gaussian", "psparse")


def validate_proj_kind(proj_kind: str) -> None:
    if proj_kind not in PROJ_KINDS:
        raise ValueError(
            f"proj_kind must be one of {PROJ_KINDS}, got {proj_kind!r}")


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static configuration of the sketching framework."""

    rank: int = 2                   # initial target rank r0
    max_rank: int = 16              # r_max: buffers sized k_max = 2*r_max+1
    beta: float = 0.95              # EMA momentum
    batch_size: int = 128           # Nb, rows of the projection matrices
    dtype: torch.dtype = torch.float32   # sketch arithmetic dtype
    # reconstruction: "faithful" = paper Eqs. 6-7 with pinv; "fast" =
    # ridge-regularised normal-equation solves
    recon_mode: str = "faithful"
    ridge: float = 1e-4             # RELATIVE ridge for "fast" solves
    # projection family: "gaussian" = dense (Nb, k_max) matrices;
    # "psparse" = seeds-only p-sparsified projections
    proj_kind: str = "gaussian"
    proj_density: float = 0.1       # psparse nonzero fraction p

    def __post_init__(self):
        validate_proj_kind(self.proj_kind)

    @property
    def k0(self) -> int:
        return 2 * self.rank + 1

    @property
    def k_max(self) -> int:
        return 2 * self.max_rank + 1
