"""Activation reconstruction from the EMA sketches, paper §4.2, Eqs. 6-7
(counterpart of ``repro.core.reconstruct``).

    Y_s = Q_Y R_Y ;  X_s = Q_X R_X            (QR, d x k)
    C_inter = Q_Y^T Z_s
    X_s^T   = P_X R'_X                        (QR, k x k)
    C       = P_X^T C_inter^T
    A~      = Omega Y_s^+ Q_Y C Q_X^T         (N_b x d)

A~ is rank-k, so it is kept factored: A~ = left @ right^T with
left = Omega (Y^+ Q_Y) C (N_b x k) and right = Q_X (d x k); no d x d
matrix is formed. Columns >= k_active are exactly zero throughout.

All of this is k-thin work on (d, k) and (k, k) matrices through
``torch.linalg``; no TPU kernel does it. A~ depends on the column signs
of the QR factors, so it matches the reference only where both QRs take
the same (LAPACK) sign convention.

Both modes return NaN on a sketch that holds a NaN or an inf, and never
raise: the train step's NaN guard then skips the step, on the card as on
the CPU (``pinv``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sketches.update import mask_columns

Tensor = torch.Tensor


@dataclasses.dataclass
class Reconstruction:
    """A~ ~ left @ right^T   with left (..., N_b, k), right (..., d, k)."""

    left: Tensor
    right: Tensor

    def dense(self) -> Tensor:
        return self.left @ self.right.mT


def masked_qr(a: Tensor, k_active) -> Tensor:
    """Reduced QR's Q with columns >= k_active zeroed."""
    q, _ = torch.linalg.qr(a)
    return mask_columns(q, k_active)


def pinv(a: Tensor) -> Tensor:
    """``jnp.linalg.pinv`` of (..., m, n), batched over leading dims:
    singular values at most 10 * max(m, n) * eps * sigma_max are
    dropped. A matrix holding a NaN or an inf gives an all-NaN result,
    where ``torch.linalg.pinv`` would raise (its SVD refuses non-finite
    input). The reference returns all NaN for a NaN; for an inf LAPACK
    gives it a mix of NaN and 0, or does not return at all (ROADMAP
    §C, C5), so the port takes NaN there too. No host sync: the pinv of
    the matrix with its non-finite entries zeroed, then NaN over each
    matrix that had one."""
    finite = torch.isfinite(a)
    rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    p = torch.linalg.pinv(torch.where(finite, a, 0.0), rtol=rtol)
    ok = finite.all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(ok, p, torch.nan)


def _pinv_apply(y_s: Tensor, rhs: Tensor, mode: str, ridge: float) -> Tensor:
    """Y^+ @ rhs: SVD pinv ("faithful", ``pinv``), or the
    ridge-regularised normal equations ("fast"), with the ridge RELATIVE
    to trace(Y^T Y)/k. The solve does not check its factorisation, as
    ``jnp.linalg.solve`` does not: a sketch holding a NaN gives a NaN
    result, where the card's ``torch.linalg.solve`` would raise (its LU
    reports the NaN matrix singular)."""
    if mode == "faithful":
        return pinv(y_s) @ rhs
    g = y_s.T @ y_s                              # (k, k)
    k = g.shape[0]
    lam = ridge * (torch.trace(g) / k + 1e-30)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    return torch.linalg.solve_ex(g + lam * eye, y_s.T @ rhs).result


def _factors(x_s, y_s, z_s, omega, k_active):
    dt = torch.promote_types(x_s.dtype, torch.float32)
    x_s, y_s, z_s, omega = (mask_columns(t.to(dt), k_active)
                            for t in (x_s, y_s, z_s, omega))
    q_y = masked_qr(y_s, k_active)               # (d, k)
    c_inter = q_y.T @ z_s                        # (k, s)
    p_x = masked_qr(x_s.T, k_active)             # (k, k)
    c = p_x.T @ c_inter.T                        # (k, k)  [s = k]
    q_x = masked_qr(x_s, k_active)               # (d, k)
    return y_s, omega, q_y, c, q_x


def reconstruct(x_s: Tensor, y_s: Tensor, z_s: Tensor, omega: Tensor,
                k_active, *, mode: str = "faithful",
                ridge: float = 1e-4) -> Reconstruction:
    """The node's batch activation matrix from its EMA triple, factored.
    x/y/z (d, k_max); omega (N_b, k_max); k_active a 0-d tensor."""
    y_s, omega, q_y, c, q_x = _factors(x_s, y_s, z_s, omega, k_active)
    ypq = _pinv_apply(y_s, q_y, mode, ridge)   # (k, k)
    return Reconstruction(left=omega @ (ypq @ c), right=q_x)


def reconstruct_dense_faithful(x_s, y_s, z_s, omega, k_active, *,
                               mode: str = "faithful",
                               ridge: float = 1e-6) -> Tensor:
    """The literal paper path: materialise G~ (d x d), then project
    (Eq. 7). Tests hold the factored path against it."""
    y_s, omega, q_y, c, q_x = _factors(x_s, y_s, z_s, omega, k_active)
    g = q_y @ c @ q_x.T                          # (d, d) feature structure
    return omega @ _pinv_apply(y_s, g, mode, ridge)
