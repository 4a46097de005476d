"""xLSTM blocks: chunkwise mLSTM and sequential sLSTM (counterpart of
``repro.models.ssm``).

mLSTM is a gated linear-attention recurrence with matrix memory
    C_t = f_t C_{t-1} + i_t k_t v_t^T,  n_t = f_t n_{t-1} + i_t k_t,
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))
with exponential gating stabilised by the running max m_t. Train, eval
and prefill run the stabilised chunkwise form from a zero state through
``kernels.mlstm_chunk`` (the Hopper kernels on the card, the plain
version on the CPU), where the reference runs its own scan
``_mlstm_chunk_scan``; train mode goes through ``mlstm_chunk_train``,
whose backward is the ``mlstm_chunk_bwd`` kernels (the reference takes
jax.grad of its scan). Decode is the one-step recurrence ``mlstm_step``,
plain PyTorch as the reference computes it in XLA.

sLSTM has scalar memory with block-diagonal (per-head) recurrent
mixing: one Python loop over time, and its gradient is autograd through
that loop (the reference has no kernel there). The reference's per-step
and chunked scans compute the same cells in the same order.

Parameters and caches keep the reference's names and layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import (
    chunk_width, mlstm_chunk, mlstm_chunk_train,
)
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor
MLSTM_CHUNK = 256        # the reference's chunk for prefill and eval


# ---------------------------------------------------------------------------
# causal depthwise conv (shift-and-sum form; decode keeps a width-1 tail)
# ---------------------------------------------------------------------------


def causal_conv(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """x (B, S, F), w (W, F) depthwise causal conv."""
    W = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(W):
        xi = x if i == 0 else F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + xi * w[W - 1 - i][None, None, :]
    if b is not None:
        out = out + b[None, None, :]
    return out


def causal_conv_step(x_t: Tensor, conv_state: Tensor, w: Tensor,
                     b: Tensor | None = None):
    """x_t (B, F), conv_state (B, W-1, F) holding previous inputs.
    Returns (y_t (B, F), new_conv_state)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)     # (B, W, F)
    y = torch.einsum("bwf,wf->bf", full, w)
    if b is not None:
        y = y + b[None, :]
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg):
    inner = 2 * cfg.d_model
    H = cfg.num_heads
    dv = inner // H
    dk = max(dv // 2, 4)
    return inner, H, dk, dv


def mlstm_init(gen, cfg, dtype) -> dict:
    d = cfg.d_model
    inner, H, dk, dv = mlstm_dims(cfg)
    dev = gen.device
    return {
        "w_m_up": dense_init(gen, (d, inner), dtype),
        "w_m_z": dense_init(gen, (d, inner), dtype),
        "w_m_q": dense_init(gen, (inner, H, dk), dtype, fan_in=inner),
        "w_m_k": dense_init(gen, (inner, H, dk), dtype, fan_in=inner),
        "w_m_gates": dense_init(gen, (inner, 2 * H), dtype, fan_in=inner),
        "b_gates": torch.cat([
            torch.zeros((H,), device=dev),
            torch.linspace(3.0, 6.0, H, device=dev)]).to(dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, inner), dtype,
                             fan_in=cfg.conv_width),
        "w_m_down": dense_init(gen, (inner, d), dtype, fan_in=inner),
    }


def mlstm_step(q, k, v, li, lf, C, n, m):
    """One decode step. q, k (B, H, Dk); v (B, H, Dv); li, lf (B, H)."""
    Dk = q.shape[-1]
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    C_new = fs[..., None, None] * C + is_[..., None, None] * \
        torch.einsum("bhd,bhv->bhdv", k, v)
    n_new = fs[..., None] * n + is_[..., None] * k
    qn = q * Dk ** -0.5
    num = torch.einsum("bhd,bhdv->bhv", qn, C_new)
    den = torch.einsum("bhd,bhd->bh", qn, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C_new, n_new, m_new)


def mlstm_sequential_ref(q, k, v, li, lf, C0, n0, m0):
    """Step-by-step oracle for the chunked form (tests only)."""
    carry = (C0, n0, m0)
    hs = []
    for t in range(q.shape[2]):
        h, carry = mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                              li[..., t], lf[..., t], *carry)
        hs.append(h)
    return torch.stack(hs, dim=2), carry


def mlstm_apply(p, x, *, cfg, mode, cache=None, chunk=MLSTM_CHUNK,
                return_carry=False):
    """Full mLSTM block. x (B, S, d) -> (y, new_cache); the cache is
    {"C", "m_n", "m_m", "conv"} in prefill and decode, None in train and
    eval. With ``return_carry`` a third output is the end-of-sequence
    matrix memory (C (B, H, dk, dv), n (B, H, dk)), which the
    mlstm_c/mlstm_n sketch nodes observe; it carries no gradient."""
    B, S, d = x.shape
    inner, H, dk, dv = mlstm_dims(cfg)
    dt = x.dtype
    up = x @ p["w_m_up"].to(dt)                      # (B, S, inner)
    z = x @ p["w_m_z"].to(dt)

    if mode == "decode":
        xc_t, conv_state = causal_conv_step(up[:, 0], cache["conv"],
                                            p["conv_w"].to(dt))
        xc = F.silu(xc_t.float()).to(dt)[:, None]
    else:
        xc = causal_conv(up, p["conv_w"].to(dt))
        xc = F.silu(xc.float()).to(dt)
        W = cfg.conv_width
        conv_state = up[:, -(W - 1):] if S >= W else \
            F.pad(up, (0, 0, W - 1 - S, 0))

    q = torch.einsum("bsi,ihd->bhsd", xc, p["w_m_q"].to(dt))
    k = torch.einsum("bsi,ihd->bhsd", xc, p["w_m_k"].to(dt))
    v = up.reshape(B, S, H, dv).transpose(1, 2)      # a view, no copy
    gates = (xc @ p["w_m_gates"].to(dt)).float() + p["b_gates"].float()
    li = gates[..., :H].transpose(1, 2)              # (B, H, S) log input gate
    lf = F.logsigmoid(gates[..., H:]).transpose(1, 2)

    if mode == "decode":
        h, (C, n, m) = mlstm_step(
            q[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float(),
            li[:, :, 0], lf[:, :, 0], cache["C"], cache["m_n"],
            cache["m_m"])
        h = h[:, :, None]
    else:
        # q, k and v stay in the compute type: the kernel widens them
        # exactly, as the reference's astype(float32) does
        run = mlstm_chunk_train if mode == "train" else mlstm_chunk
        h, (C, n, m) = run(q, k, v, li, lf, chunk=chunk)

    h = h.transpose(1, 2).reshape(B, S, inner).to(dt)
    out = h * F.silu(z.float()).to(dt)
    y = out @ p["w_m_down"].to(dt)
    new_cache = {"C": C, "m_n": n, "m_m": m, "conv": conv_state} \
        if mode in ("decode", "prefill") else None
    if return_carry:
        return y, new_cache, (C, n)
    return y, new_cache


def init_mlstm_cache(cfg, batch: int, dtype, device) -> dict:
    inner, H, dk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dk, dv), **f32),
        "m_n": torch.zeros((batch, H, dk), **f32),
        "m_m": torch.zeros((batch, H), **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, inner), dtype=dtype,
                            device=device),
    }


def check_prompt_len(S: int) -> None:
    """Raises ValueError unless prefill can chunk S tokens: at most one
    chunk, or a whole number of them (the reference asserts it)."""
    chunk_width(S, MLSTM_CHUNK)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg, dtype) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dev = gen.device
    return {
        "w_s_in": dense_init(gen, (d, 4 * d), dtype),
        "r_s": dense_init(gen, (4, H, dh, dh), dtype, fan_in=dh) * 0.1,
        "b_s": torch.cat([
            torch.zeros((2 * d,), device=dev),
            torch.linspace(3.0, 6.0, d, device=dev),
            torch.zeros((d,), device=dev)]).to(dtype),
        "w_s_out": dense_init(gen, (d, d), dtype),
    }


def pack_recurrent(r_s: Tensor) -> Tensor:
    """The recurrent weights (4, H, dh, dh) as (H, dh, 4 dh), f32: each
    head's four gate matrices side by side, for ``slstm_cell``'s one
    batched product a step. Packed once a block: a product that permuted
    r_s every step would keep a permuted copy for the backward each step
    (16 MB at xlstm-1.3b, 48 GB over a 512-step sequence and 6 layers)."""
    g, H, dh, _ = r_s.shape
    return r_s.float().permute(1, 2, 0, 3).reshape(H, dh, g * dh)


def slstm_cell(zx, ix, fx, ox, state, r_hd, H):
    """One sLSTM step. gate inputs (B, d) f32; state (c, n, m, h) (B, d);
    r_hd the packed recurrent weights (``pack_recurrent``)."""
    c, n, m, h = state
    B, d = zx.shape
    dh = d // H
    hh = h.reshape(B, H, dh)
    # rec[g, b, h, e] = sum_d hh[b, h, d] r_s[g, h, d, e]
    rec = torch.bmm(hh.transpose(0, 1), r_hd)        # (H, B, 4 dh)
    rec = rec.reshape(H, B, 4, dh).permute(2, 1, 0, 3).reshape(4, B, d)
    z = torch.tanh(zx + rec[0])
    li = ix + rec[1]
    lf = F.logsigmoid(fx + rec[2])
    o = torch.sigmoid(ox + rec[3])
    m_new = torch.maximum(lf + m, li)
    i_ = torch.exp(li - m_new)
    f_ = torch.exp(lf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def slstm_apply(p, x, *, cfg, mode, cache=None):
    """Sequential sLSTM block. x (B, S, d) -> (y, new_cache)."""
    B, S, d = x.shape
    H = cfg.num_heads
    dt = x.dtype
    gates = (x @ p["w_s_in"].to(dt)).float() + p["b_s"].float()
    zx, ix, fx, ox = torch.split(gates, d, dim=-1)
    r_hd = pack_recurrent(p["r_s"])

    if mode == "decode":
        state = (cache["s_c"], cache["s_n"], cache["s_m"], cache["s_h"])
    else:
        zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        state = (zero, zero, zero, zero)
    hs = []
    for t in range(S):
        state = slstm_cell(zx[:, t], ix[:, t], fx[:, t], ox[:, t], state,
                           r_hd, H)
        hs.append(state[3])
    hs = torch.stack(hs, dim=1)                     # (B, S, d)

    y = hs.to(dt) @ p["w_s_out"].to(dt)
    new_cache = {"s_c": state[0], "s_n": state[1], "s_m": state[2],
                 "s_h": state[3]} if mode in ("decode", "prefill") else None
    return y, new_cache


def init_slstm_cache(cfg, batch: int, dtype, device) -> dict:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"s_c": z, "s_n": z.clone(), "s_m": z.clone(), "s_h": z.clone()}
