"""The canonical EMA-triple update, paper Eqs. 5a-5c (counterpart of
``repro.sketches.update``).

Every update goes through a fused kernel wrapper: ``sketch_update`` for
dense Gaussian projections, ``psparse_update`` for seeds-only
p-sparsified ones (``proj_triple_update`` picks by projection kind). On
CUDA tensors a wrapper launches its Hopper kernel, on CPU tensors it
computes the plain version. The caller's contract is the reference's
kernel path: projections and psi are masked to ``k_active`` before the
kernel, the kernel works in f32, and its outputs are cast back to the
sketch dtype and masked again. Every function returns new tensors and
leaves its inputs as they were, so a triple saved for a backward is
never changed under it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.psparse_update import psparse_update
from repro_torch.kernels.sketch_update import sketch_update
from repro_torch.sketches.psparse import is_psparse

Tensor = torch.Tensor


def active_mask(k_active: Tensor, k_max: int, dtype=torch.float32) -> Tensor:
    """(k_max,) 1.0 for columns < k_active else 0.0."""
    idx = torch.arange(k_max, device=k_active.device)
    return (idx < k_active).to(dtype)


def mask_columns(m: Tensor, k_active: Tensor) -> Tensor:
    """Zero the inactive trailing columns of (..., k_max)."""
    return m * active_mask(k_active, m.shape[-1], m.dtype).to(m.device)


def proj_num_tokens(proj) -> int:
    """The token-row binding T of a projection: ``num_tokens`` of
    psparse projections, else the rows of the dense matrices."""
    return proj.num_tokens if is_psparse(proj) else proj["omega"].shape[0]


def pad_activation_rows(a: Tensor, num_tokens: int) -> Tensor:
    """Zero-pad a (rows, d) activation to the tree's (T, d) binding:
    zero rows add nothing to any increment, whatever the projection
    kind (psparse hashes bind rows to [0, T))."""
    rows = a.shape[0]
    if rows == num_tokens:
        return a
    if rows > num_tokens:
        raise ValueError(
            f"activation has {rows} rows but the sketch tree is bound "
            f"to num_tokens={num_tokens}; re-init the tree with "
            f"num_tokens >= the largest node's row count")
    return torch.nn.functional.pad(a, (0, 0, 0, num_tokens - rows))


def limit_rows(proj, rows: int):
    """The projections for an activation of ``rows`` rows, fewer than
    the tree's binding T (a carry's B rows): the dense matrices' first
    ``rows`` rows, or psparse projections as they are (their kernel
    skips the support rows past the activation's). The update against
    them is the update of the activation zero-padded to T rows
    (``pad_activation_rows``), whose zero rows add nothing, without the
    (T, d) pad."""
    T = proj_num_tokens(proj)
    if rows > T:
        raise ValueError(
            f"activation has {rows} rows but the sketch tree is bound "
            f"to num_tokens={T}; re-init the tree with num_tokens >= the "
            f"largest node's row count")
    if rows == T or is_psparse(proj):
        return proj
    return {name: t[:rows] for name, t in proj.items()}


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def _masked_f32(mats, mask: Tensor):
    """Each matrix cast to the sketch dtype (``mask.dtype``),
    column-masked, then widened to f32 for the kernel."""
    return [_f32(m.to(mask.dtype) * mask) for m in mats]


def ema_triple_update(
    x_s: Tensor,            # (d, k_max) input/co-range sketch X_s
    y_s: Tensor,            # (d, k_max) output/range sketch Y_s
    z_s: Tensor,            # (d, k_max) interaction sketch Z_s
    a: Tensor,              # (T, d) the node's activation
    upsilon: Tensor,        # (T, k_max)
    omega: Tensor,          # (T, k_max)
    phi: Tensor,            # (T, k_max)
    psi: Tensor,            # (k_max,) node-specific interaction weights
    beta: float,
    k_active: Tensor,       # () int — active k = 2r+1
) -> tuple[Tensor, Tensor, Tensor]:
    """One EMA sketch update; returns masked (x, y, z) in x_s.dtype."""
    dt = x_s.dtype
    mask = active_mask(k_active, x_s.shape[-1], dt)   # mask_columns, once
    ups, omg, ph, ps = _masked_f32((upsilon, omega, phi, psi), mask)
    xn, yn, zn = sketch_update(
        a.detach().contiguous(), _f32(x_s), _f32(y_s), _f32(z_s),
        ups, omg, ph, ps, beta=float(beta))
    return tuple(o.to(dt) * mask for o in (xn, yn, zn))


def ema_triple_increment(x_s, y_s, z_s, a, upsilon, omega, phi, psi,
                         beta: float, k_active):
    """The masked (1-beta)-scaled f32 increments of one EMA update: the
    kernel with zero input sketches. x_s/y_s/z_s give only the shape
    and the dtype the projections are cast to."""
    mask = active_mask(k_active, x_s.shape[-1], x_s.dtype)
    ups, omg, ph, ps = _masked_f32((upsilon, omega, phi, psi), mask)
    zeros = torch.zeros(x_s.shape, dtype=torch.float32, device=x_s.device)
    return sketch_update(a.detach().contiguous(), zeros, zeros, zeros,
                         ups, omg, ph, ps, beta=float(beta))


def ema_apply_increment(x_s: Tensor, inc: Tensor, beta: float,
                        k_active) -> Tensor:
    """Fold an increment into the EMA state: ``mask(beta * x + inc)``
    in the increment's dtype, cast back to the sketch dtype."""
    xn = beta * x_s.to(inc.dtype) + inc
    return mask_columns(xn.to(x_s.dtype), k_active)


def proj_triple_update(x_s, y_s, z_s, a, proj, psi, beta, k_active):
    """``ema_triple_update`` routed by projection kind: a dense
    {"upsilon","omega","phi"} dict, or ``PsparseProjections``, whose
    implicit matrices the psparse kernel regenerates from their 12
    coefficients. psi is masked before the kernel and the outputs
    after, as in the reference's kernel branch."""
    if not is_psparse(proj):
        return ema_triple_update(x_s, y_s, z_s, a, proj["upsilon"],
                                 proj["omega"], proj["phi"], psi, beta,
                                 k_active)
    ps = _f32(mask_columns(psi.to(torch.float32), k_active))
    outs = psparse_update(a.detach().contiguous(), _f32(x_s), _f32(y_s),
                          _f32(z_s), proj.params, ps, beta=float(beta),
                          m=proj.m, num_tokens=proj.num_tokens)
    return tuple(mask_columns(o.to(x_s.dtype), k_active) for o in outs)


def proj_triple_increment(x_s, y_s, z_s, a, proj, psi, beta, k_active):
    """``ema_triple_increment`` routed by projection kind. Increments
    keep their (d, k_max) shape whatever the kind; x and y are masked
    explicitly, z through psi."""
    if not is_psparse(proj):
        return ema_triple_increment(x_s, y_s, z_s, a, proj["upsilon"],
                                    proj["omega"], proj["phi"], psi, beta,
                                    k_active)
    ps = _f32(mask_columns(psi.to(torch.float32), k_active))
    zeros = torch.zeros(x_s.shape, dtype=torch.float32, device=x_s.device)
    ix, iy, iz = psparse_update(a.detach().contiguous(), zeros, zeros,
                                zeros, proj.params, ps, beta=float(beta),
                                m=proj.m, num_tokens=proj.num_tokens)
    return mask_columns(ix, k_active), mask_columns(iy, k_active), iz


# -- the corange (Tropp) triple ----------------------------------------------
#
# Three plain products against the batch matrix M = a^T (d, N_b); the
# reference computes them outside any Pallas kernel, so no update kernel
# runs for a corange node. Leading dims of the triple and of ``a`` are
# batch dims (a stacked node's layers), which the projections broadcast
# over.


def _mask_rows(m: Tensor, k_active) -> Tensor:
    """Zero the inactive trailing rows of (..., k_max, n)."""
    return mask_columns(m.mT, k_active).mT


def _mask_core(z: Tensor, s_active) -> Tensor:
    return _mask_rows(mask_columns(z, s_active), s_active)


def corange_triple_update(x_c: Tensor, y_c: Tensor, z_c: Tensor, a: Tensor,
                          proj, beta: float, k_active
                          ) -> tuple[Tensor, Tensor, Tensor]:
    """EMA update of the Tropp triple against M = a^T: x_c (..., k_max,
    N_b), y_c (..., d, k_max), z_c (..., s_max, s_max), a (..., N_b, d);
    x masked along its k rows, y along its k columns, z on both dims at
    s_active = 2 k_active + 1. ``proj`` has upsilon (k_max, d), omega
    (N_b, k_max), phi (s_max, d) and psi (N_b, s_max)."""
    dt = x_c.dtype
    s_active = 2 * k_active + 1
    m = a.detach().to(dt).mT                                 # (..., d, N_b)
    ups = _mask_rows(proj.upsilon.to(dt), k_active)
    omg = mask_columns(proj.omega.to(dt), k_active)
    phi = _mask_rows(proj.phi.to(dt), s_active)
    psi = mask_columns(proj.psi.to(dt), s_active)
    x_new = beta * x_c + (1 - beta) * (ups @ m)
    y_new = beta * y_c + (1 - beta) * (m @ omg)
    z_new = beta * z_c + (1 - beta) * (phi @ (m @ psi))
    return (_mask_rows(x_new, k_active), mask_columns(y_new, k_active),
            _mask_core(z_new, s_active))

