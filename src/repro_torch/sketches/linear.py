"""Sketched-backprop linear layer, paper §4.4, Algorithm 2 (counterpart
of ``repro.sketches.linear``).

The forward is x @ w, but it saves only the weight and the node's small
sketch triple, never x: the input activation takes no part in the
backward, which is the paper's memory mechanism. The backward rebuilds
A~ = left @ right^T from the triple (``core.reconstruct``) and computes

    grad_w = A~^T @ delta       (w stored (d_in, d_out))
    grad_x = delta @ w^T        (exact: delta is never sketched)

``factored=True`` uses the factors: grad_w = right @ (left^T @ delta),
O(T k (d_in + d_out)) instead of O(T d_in d_out). The triple must not be
changed in place between forward and backward; the port's updates
return new tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.reconstruct import reconstruct

Tensor = torch.Tensor


class SketchedMatmul(torch.autograd.Function):
    """x @ w with the sketched weight gradient; the triple, omega and
    k_active get no gradient."""

    @staticmethod
    def forward(ctx, x, w, x_s, y_s, z_s, omega, k_active, recon_mode,
                ridge, factored):
        ctx.save_for_backward(w, x_s, y_s, z_s, omega, k_active)
        ctx.recon = (recon_mode, ridge, factored)
        return x @ w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w, x_s, y_s, z_s, omega, k_active = ctx.saved_tensors
        recon_mode, ridge, factored = ctx.recon
        rec = reconstruct(x_s, y_s, z_s, omega, k_active, mode=recon_mode,
                          ridge=ridge)
        gf = g.to(rec.left.dtype)
        if factored:
            grad_w = rec.right @ (rec.left.T @ gf)          # (d_in, d_out)
        else:
            grad_w = rec.dense().T @ gf
        grad_x = (g @ w.T.to(g.dtype)).to(w.dtype)
        return (grad_x, grad_w.to(w.dtype), None, None, None, None, None,
                None, None, None)


def sketched_matmul(x: Tensor, w: Tensor, x_s: Tensor, y_s: Tensor,
                    z_s: Tensor, omega: Tensor, k_active: Tensor,
                    recon_mode: str = "faithful", ridge: float = 1e-4,
                    factored: bool = True) -> Tensor:
    """x (T, d_in) @ w (d_in, d_out); the triple (d_in, k_max) and omega
    (T, k_max) are the node feeding w, already updated for this step."""
    return SketchedMatmul.apply(x, w, x_s, y_s, z_s, omega, k_active,
                                recon_mode, ridge, factored)
