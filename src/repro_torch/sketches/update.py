"""The canonical EMA-triple update, paper Eqs. 5a-5c (counterpart of
``repro.sketches.update``).

Every update goes through the fused kernel wrapper
``kernels.sketch_update.sketch_update``: on CUDA tensors it launches the
Hopper kernel, on CPU tensors it computes the plain version. The caller's
contract is the reference's kernel path (``_fused_kernel_update``):
projections and psi are masked to ``k_active`` before the kernel, the
kernel works in f32, and its outputs are cast back to the sketch dtype
and masked again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sketch_update import sketch_update

Tensor = torch.Tensor


def active_mask(k_active: Tensor, k_max: int, dtype=torch.float32) -> Tensor:
    """(k_max,) 1.0 for columns < k_active else 0.0."""
    idx = torch.arange(k_max, device=k_active.device)
    return (idx < k_active).to(dtype)


def mask_columns(m: Tensor, k_active: Tensor) -> Tensor:
    """Zero the inactive trailing columns of (..., k_max)."""
    return m * active_mask(k_active, m.shape[-1], m.dtype).to(m.device)


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
    dt, f32 = x_s.dtype, torch.float32
    mask = active_mask(k_active, x_s.shape[-1], dt)   # mask_columns, once
    ups, omg, ph, ps = ((m.to(dt) * mask).to(f32).contiguous()
                        for m in (upsilon, omega, phi, psi))
    xn, yn, zn = sketch_update(
        a.detach().contiguous(), x_s.to(f32).contiguous(),
        y_s.to(f32).contiguous(), z_s.to(f32).contiguous(),
        ups, omg, ph, ps, beta=float(beta))
    return tuple(o.to(dt) * mask for o in (xn, yn, zn))


def proj_triple_update(x_s, y_s, z_s, a, proj, psi, beta, k_active):
    """``ema_triple_update`` for a dense {"upsilon","omega","phi"}
    projection dict, the one projection kind ported so far."""
    if not isinstance(proj, dict):
        raise NotImplementedError(
            f"projections of type {type(proj).__name__} are not ported: "
            "p-sparsified projections are ROADMAP B2 (psparse_update)")
    return ema_triple_update(x_s, y_s, z_s, a, proj["upsilon"],
                             proj["omega"], proj["phi"], psi, beta, k_active)
