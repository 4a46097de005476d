"""p-sparsified projection state: seeds instead of matrices (counterpart
of ``repro.sketches.psparse``, paper layout only).

A psparse tree never materialises its (T, k_max) projections: it holds
12 uint32 multiply-shift coefficients (one row of four per matrix, host
integers) and the static geometry. The update regenerates the implicit
matrices in the kernel's registers; ``proj["omega"]`` materialises a
dense matrix for the few consumers that need one (the backward of
``sketched_matmul``), equal bit for bit to the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.psparse_update import (
    NAMES, psparse_dense_one, psparse_dim, psparse_hash_params,
    psparse_rows, psparse_scale, psparse_signs,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PsparseProjections:
    """Implicit {upsilon, omega, phi}: ``params[i]`` = (a_row, b_row,
    a_sign, b_sign) for matrix i in ``NAMES`` order. ``device`` is where
    materialised matrices are made."""

    params: tuple[tuple[int, int, int, int], ...]
    num_tokens: int
    k_max: int
    density: float = 0.1
    device: str | torch.device = "cpu"

    @property
    def m(self) -> int:
        """Support rows per matrix: clamp(round(p*T), k_max, T)."""
        return psparse_dim(self.num_tokens, self.k_max, self.density)

    @property
    def scale(self) -> float:
        """Entry magnitude alpha = sqrt(T/m) (unit entry variance)."""
        return psparse_scale(self.num_tokens, self.m)

    def __getitem__(self, name: str) -> Tensor:
        return psparse_dense_one(self.params[NAMES.index(name)],
                                 self.num_tokens, self.k_max, self.m,
                                 self.device)

    def rows(self, name: str) -> Tensor:
        """(m,) support rows of one implicit matrix."""
        return psparse_rows(self.params[NAMES.index(name)], self.m,
                            self.num_tokens, self.device)

    def signs(self, name: str) -> Tensor:
        """(m, k_max) UNSCALED +-1 sign pattern of one implicit matrix."""
        return psparse_signs(self.params[NAMES.index(name)], self.m,
                             self.k_max, self.device)

    def to(self, device) -> "PsparseProjections":
        return dataclasses.replace(self, device=torch.device(device))


def init_psparse_projections(gen: torch.Generator, num_tokens: int,
                             k_max: int, density: float
                             ) -> PsparseProjections:
    return PsparseProjections(
        params=psparse_hash_params(gen), num_tokens=num_tokens,
        k_max=k_max, density=density, device=gen.device)


def refresh_psparse_projections(proj: PsparseProjections,
                                gen: torch.Generator) -> PsparseProjections:
    """Fresh independent projections at the same geometry: 12 new
    coefficients drawn from ``gen``."""
    return dataclasses.replace(
        proj, params=psparse_hash_params(gen, rows=len(proj.params)))


def is_psparse(proj) -> bool:
    return isinstance(proj, PsparseProjections)
