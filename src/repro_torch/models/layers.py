"""Shared building blocks: inits, RMSNorm, RoPE, embedding, dense MLP
(counterpart of ``repro.models.layers``).

Parameters are nested dicts of tensors with the JAX package's names and
layouts, so weights carry across one to one (``repro_torch.interop``).
Every function casts its weights to the activation dtype at the point of
use, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None) -> Tensor:
    """N(0, 1/fan_in) weights drawn on the generator's device."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * (1.0 / fan_in) ** 0.5).to(dtype)


def rmsnorm_init(d, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x: Tensor, eps=1e-6) -> Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dt) * p["scale"].to(dt)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., S, H, D) with positions (..., S) -> rotated x."""
    d_half = x.shape[-1] // 2
    idx = torch.arange(0, d_half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / d_half))
    ang = positions.float()[..., None] * freqs             # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :d_half].float(), x[..., d_half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_init(gen, vocab, d, dtype, tie: bool) -> dict:
    p = {"embedding": dense_init(gen, (vocab, d), dtype, fan_in=d)}
    if not tie:
        p["head"] = dense_init(gen, (vocab, d), dtype, fan_in=d)
    return p


def embed_apply(p, tokens: Tensor, dtype) -> Tensor:
    return p["embedding"].to(dtype)[tokens]


def unembed_apply(p, x: Tensor, dtype) -> Tensor:
    """Logits against the separate ``head`` or, tied, the embedding."""
    table = p.get("head", p["embedding"])
    return torch.einsum("bsd,vd->bsv", x, table.to(dtype))


def mlp_init(gen, d, d_ff, mlp_type, dtype) -> dict:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, d_ff), dtype),
            "w_up": dense_init(gen, (d, d_ff), dtype),
            "w_down": dense_init(gen, (d_ff, d), dtype),
        }
    if mlp_type == "gelu":
        return {
            "w_up": dense_init(gen, (d, d_ff), dtype),
            "w_down": dense_init(gen, (d_ff, d), dtype),
        }
    raise ValueError(mlp_type)


def mlp_apply(p, x: Tensor, mlp_type: str) -> Tensor:
    """Dense FFN; the activation runs in f32 as in the reference
    (``jax.nn.gelu`` defaults to the tanh approximation)."""
    dt = x.dtype
    if mlp_type == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
    else:
        h = F.gelu((x @ p["w_up"].to(dt)).float(),
                   approximate="tanh").to(dt)
    return h @ p["w_down"].to(dt)
