"""The co-range (Tropp) sketch variant (counterpart of
``repro.core.corange``).

The original three-sketch of Tropp et al. applied to the EMA activation
matrix M = A_EMA^T (d x N_b), at the paper triple's memory cost:

    X_c = Upsilon_c M        (k x N_b)   co-range sketch
    Y_c = M Omega_c          (d x k)     range sketch
    Z_c = Phi_c M Psi_c      (s x s)     core sketch, s = 2k + 1

All three are linear in M, so the EMA recurrence holds as for the paper
triple (``sketches.update.corange_triple_update``). The reconstruction

    X_c^T = P R1 ;  Y_c = Q R2
    C = (Phi_c Q)^+ Z_c ((Psi_c^T P)^+)^T
    M~ = Q C P^T        with  E||M - M~||_F <= sqrt(6) tau_{r+1}(M)

is returned as A~ = M~^T = left @ right^T, left = P, right = Q C.

A~ does not depend on the QR factors' column signs: for a diagonal
D = diag(+-1), Q D (Phi Q D)^+ = Q D D (Phi Q)^+ = Q (Phi Q)^+, and so
for P. So the card's QR convention (cuSOLVER's) cannot move A~, though
it may flip the signs of the factors. All of it is k-thin work through
``torch.linalg``; no TPU kernel does it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.reconstruct import Reconstruction, masked_qr, pinv
from repro_torch.sketches.update import (
    _mask_rows, corange_triple_update, mask_columns,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class CorangeProjections:
    upsilon: Tensor    # (k_max, d)    feature-space co-range projection
    omega: Tensor      # (N_b, k_max)  batch-space range projection
    phi: Tensor        # (s_max, d)    core left projection
    psi: Tensor        # (N_b, s_max)  core right projection

    def to(self, device) -> "CorangeProjections":
        return CorangeProjections(*(t.detach().to(device=device, copy=True)
                                    for t in (self.upsilon, self.omega,
                                              self.phi, self.psi)))


def s_of(k: int) -> int:
    """Core-sketch dim: s = 2k + 1 (Tropp's stability requirement)."""
    return 2 * k + 1


def make_corange_projections(gen: torch.Generator, d: int, n_b: int,
                             k_max: int, dtype=torch.float32
                             ) -> CorangeProjections:
    """Four N(0, 1) matrices drawn from ``gen`` in field order, on its
    device."""
    s_max = s_of(k_max)

    def g(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    return CorangeProjections(upsilon=g(k_max, d), omega=g(n_b, k_max),
                              phi=g(s_max, d), psi=g(n_b, s_max))


def corange_update(x_c, y_c, z_c, a, proj, beta: float, k_active):
    """EMA update of the Tropp triple against M = a^T
    (``sketches.update.corange_triple_update``)."""
    return corange_triple_update(x_c, y_c, z_c, a, proj, beta, k_active)


def corange_reconstruct(x_c: Tensor, y_c: Tensor, z_c: Tensor, proj,
                        k_active) -> Reconstruction:
    """A~ = M~^T from the triple: left = P (..., N_b, k), right = Q C
    (..., d, k). Leading dims of the triple are batch dims: the QRs and
    pinvs run batched over them."""
    dt = torch.promote_types(x_c.dtype, torch.float32)
    x_c, y_c, z_c = x_c.to(dt), y_c.to(dt), z_c.to(dt)
    s_active = 2 * k_active + 1
    p = masked_qr(x_c.mT, k_active)                       # (..., N_b, k)
    q = masked_qr(y_c, k_active)                          # (..., d, k)
    phi_q = _mask_rows(proj.phi.to(dt), s_active) @ q     # (..., s, k)
    psi_p = mask_columns(proj.psi.to(dt), s_active).mT @ p
    c1 = pinv(phi_q) @ z_c                                # (..., k, s)
    c = c1 @ pinv(psi_p).mT                               # (..., k, k)
    return Reconstruction(left=p, right=q @ c)

