"""p-sparsified projection state: seeds instead of matrices (counterpart
of ``repro.sketches.psparse``): the paper layout's shared-support
matrices, and the corange layout's iid ones.

A psparse tree never materialises its (T, k_max) projections: it holds
12 uint32 multiply-shift coefficients (one row of four per matrix, host
integers) and the static geometry. The update regenerates the implicit
matrices in the kernel's registers; ``proj["omega"]`` materialises a
dense matrix for the few consumers that need one (the backward of
``sketched_matmul``), equal bit for bit to the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels._hash import MASK32, mul32
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
    return isinstance(proj, (PsparseProjections, PsparseCorangeProjections))


# -- the corange (Tropp) layout: the same seeds-only storage ----------------


def _iid_sparse(params_m, n: int, k: int, density: float, transpose: bool,
                device="cpu") -> Tensor:
    """An (n, k) [(k, n) transposed] iid p-sparsified f32 matrix: entry
    (u, j) is +-1/sqrt(p) where the keep hash of the packed index
    (u << 16) | j falls under p * 2**32, else 0; the sign is the top bit
    of the sign hash. Bit for bit the reference's: every coordinate of
    the contraction axis takes part, which the corange reconstruction's
    pinv needs."""
    u = torch.arange(n, dtype=torch.int64, device=device)
    j = torch.arange(k, dtype=torch.int64, device=device)
    gidx = ((u[:, None] << 16) & MASK32) | j[None, :]
    thr = int(round(density * 2**32))
    if thr >= 2**32:
        keep = torch.ones((n, k), dtype=torch.float32, device=device)
    else:
        keep_h = (mul32(params_m[0], gidx) + params_m[1]) & MASK32
        keep = (keep_h < thr).to(torch.float32)
    sgn = 1.0 - 2.0 * (((mul32(params_m[2], gidx) + params_m[3]) & MASK32)
                       >> 31).to(torch.float32)
    dense = keep * sgn * (1.0 / math.sqrt(density))
    return dense.T if transpose else dense


@dataclasses.dataclass(frozen=True)
class PsparseCorangeProjections:
    """Implicit Tropp projections (``core.corange`` layout): one row of
    four uint32 coefficients per matrix, in (upsilon, omega, phi, psi)
    order, as host integers. The properties materialise each dense
    matrix on ``device``, so the corange update and reconstruction take
    this object as they take ``CorangeProjections``."""

    params: tuple[tuple[int, int, int, int], ...]
    d: int
    n_b: int
    k_max: int
    density: float = 0.1
    device: str | torch.device = "cpu"

    @property
    def s_max(self) -> int:
        return 2 * self.k_max + 1

    def _dense(self, i: int, n: int, k: int, transpose: bool) -> Tensor:
        return _iid_sparse(self.params[i], n, k, self.density, transpose,
                           self.device)

    @property
    def upsilon(self) -> Tensor:          # (k_max, d), contracts d
        return self._dense(0, self.d, self.k_max, True)

    @property
    def omega(self) -> Tensor:            # (N_b, k_max), contracts N_b
        return self._dense(1, self.n_b, self.k_max, False)

    @property
    def phi(self) -> Tensor:              # (s_max, d), contracts d
        return self._dense(2, self.d, self.s_max, True)

    @property
    def psi(self) -> Tensor:              # (N_b, s_max), contracts N_b
        return self._dense(3, self.n_b, self.s_max, False)

    def to(self, device) -> "PsparseCorangeProjections":
        return dataclasses.replace(self, device=torch.device(device))


def make_psparse_corange_projections(gen: torch.Generator, d: int, n_b: int,
                                     k_max: int, density: float
                                     ) -> PsparseCorangeProjections:
    return PsparseCorangeProjections(
        params=psparse_hash_params(gen, rows=4), d=d, n_b=n_b, k_max=k_max,
        density=density, device=gen.device)
