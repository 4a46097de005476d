"""RG-LRU recurrent block of Griffin / RecurrentGemma (counterpart of
``repro.models.rglru``).

Diagonal gated linear recurrence
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_r xi_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_i xi_t) * xi_t)
over the output xi of a causal depthwise conv (``ssm.causal_conv``).
Train, eval and prefill run the recurrence as a log-depth scan
(``rglru_scan``), where the reference runs ``lax.associative_scan``; its
gradient is the same scan run backwards, so autograd keeps log a and h
a layer and not the scan's ceil(log2 S) intermediates. The reference has
no Pallas kernel here: plain PyTorch is the port. In train mode the
block is recomputed in the backward (``torch.utils.checkpoint``), so
autograd keeps its input alone, where the reference rematerialises its
layers (``remat_policy``): the block's own f32 gates and scan would
otherwise keep about 460 MB a layer at recurrentgemma-2b's width and
4,096 tokens. It launches no kernel, so the recomputation counts none.
Decode is the one-step form on a constant (B, lru) state.

Roundings as the reference's: the gate and x branches and the conv in
the compute type, the gates and the scan in f32 (``w_rec_gate``,
``w_input_gate`` and ``a_param`` are read in f32, and the serving engine
keeps them f32: ``transformer.F32_LEAVES``), h rounded to the compute
type before its product with gelu(gate) (the tanh approximation, as
``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import causal_conv, causal_conv_step

Tensor = torch.Tensor
_C = 8.0   # Griffin's fixed decay sharpness


def lru_dim(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_init(gen, cfg, dtype) -> dict:
    d, lru = cfg.d_model, lru_dim(cfg)
    dev = gen.device
    # Lambda so that a ~ U[0.9, 0.999]^(1/c) at r = 0.5 (Griffin App. A)
    u = 0.9 + 0.099 * torch.rand((lru,), generator=gen, device=dev)
    a_param = torch.log(torch.expm1(-torch.log(u) * 2.0 / _C))
    return {
        "w_x": dense_init(gen, (d, lru), dtype),
        "w_gate_branch": dense_init(gen, (d, lru), dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, lru), dtype,
                             fan_in=cfg.conv_width),
        "conv_b": torch.zeros((lru,), dtype=dtype, device=dev),
        "w_input_gate": dense_init(gen, (lru, lru), dtype),
        "w_rec_gate": dense_init(gen, (lru, lru), dtype),
        "a_param": a_param.float(),
        "w_out": dense_init(gen, (lru, d), dtype),
    }


def _gates(p, xi: Tensor) -> tuple[Tensor, Tensor]:
    """log a_t (f32) and the gated input, from the conv output xi."""
    xf = xi.float()
    r = torch.sigmoid(xf @ p["w_rec_gate"].float())
    i = torch.sigmoid(xf @ p["w_input_gate"].float())
    log_a = -_C * F.softplus(p["a_param"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, gated


def _doubling_scan(log_a: Tensor, b: Tensor) -> Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t along axis 1 from h_{-1} = 0, in
    ceil(log2 S) passes: pass j combines each element with the one 2^j
    before it as the reference's ``combine`` does, (la1, b1) then (la2,
    b2) -> (la1 + la2, exp(la2) b1 + b2)."""
    S = b.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off],
                       torch.exp(log_a[:, off:]) * b[:, :-off] + b[:, off:]],
                      dim=1)
        if 2 * off < S:
            log_a = torch.cat([log_a[:, :off],
                               log_a[:, :-off] + log_a[:, off:]], dim=1)
        off *= 2
    return b


class _Scan(torch.autograd.Function):
    """``_doubling_scan`` with its gradient as the same scan reversed:
    g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t, d log_a_t = g_t a_t h_{t-1}.
    Saves log_a and h."""

    @staticmethod
    def forward(ctx, log_a, b):
        h = _doubling_scan(log_a, b)
        ctx.save_for_backward(log_a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        # a_{t+1} at t; the last step has no successor (its entry is
        # never read: the flipped scan's first element has no
        # predecessor)
        la_next = F.pad(log_a[:, 1:], (0, 0, 0, 1))
        g = _doubling_scan(la_next.flip(1), dh.flip(1)).flip(1)
        h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))
        return g * torch.exp(log_a) * h_prev, g


def rglru_scan(log_a: Tensor, b: Tensor) -> Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t along axis 1 (f32, (B, S, lru)),
    differentiable in both."""
    return _Scan.apply(log_a, b)


def rglru_apply(p, x, *, cfg, mode, cache=None, return_carry=False):
    """x (B, S, d) -> (y, new_cache); the cache is {"r_h" (B, lru) f32,
    "conv" (B, W - 1, lru)} in prefill and decode, None in train and
    eval. With ``return_carry`` a third output is the end-of-sequence
    state h_S (B, lru) f32, which the rglru_h sketch node observes; it
    carries no gradient."""
    if mode == "train":
        y, _, carry = torch.utils.checkpoint.checkpoint(
            _apply, p, x, cfg=cfg, mode=mode, cache=None,
            use_reentrant=False)
        return (y, None, carry) if return_carry else (y, None)
    y, new_cache, carry = _apply(p, x, cfg=cfg, mode=mode, cache=cache)
    return (y, new_cache, carry) if return_carry else (y, new_cache)


def _apply(p, x, *, cfg, mode, cache):
    """``rglru_apply``'s body: (y, new_cache, h_S detached)."""
    B, S, d = x.shape
    dt = x.dtype
    gate = x @ p["w_gate_branch"].to(dt)
    xr = x @ p["w_x"].to(dt)
    conv_w, conv_b = p["conv_w"].to(dt), p["conv_b"].to(dt)

    if mode == "decode":
        xi_t, conv_state = causal_conv_step(xr[:, 0], cache["conv"], conv_w,
                                            conv_b)
        log_a, gated = _gates(p, xi_t)
        h = torch.exp(log_a) * cache["r_h"] + gated          # (B, lru) f32
        hs = h[:, None]
        new_cache = {"r_h": h, "conv": conv_state}
    else:
        log_a, gated = _gates(p, causal_conv(xr, conv_w, conv_b))
        hs = rglru_scan(log_a, gated)                        # (B, S, lru)
        W = cfg.conv_width
        conv_state = xr[:, -(W - 1):] if S >= W else \
            F.pad(xr, (0, 0, W - 1 - S, 0))
        new_cache = ({"r_h": hs[:, -1], "conv": conv_state}
                     if mode == "prefill" else None)

    out = hs.to(dt) * F.gelu(gate.float(), approximate="tanh").to(dt)
    return out @ p["w_out"].to(dt), new_cache, hs[:, -1].detach()


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    lru = lru_dim(cfg)
    return {
        "r_h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, lru), dtype=dtype,
                            device=device),
    }
