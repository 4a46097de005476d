"""GQA attention: chunked-causal (train/eval/prefill) + KV-cache decode
(counterpart of ``repro.models.attention``).

Plain PyTorch math: in the JAX package this is XLA code, not a Pallas
kernel. Scores and softmax run in f32 with an additive -1e30 mask, as
in the reference. Decode supports full caches and ring-buffer windowed
caches (swa/local layers, and global layers past 262k tokens). The
decode step writes the new key/value into the cache in place, where the
reference returns an updated copy.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, rope

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_init(gen, cfg, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, cfg.num_heads, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, cfg.num_kv_heads, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, cfg.num_kv_heads, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (cfg.num_heads, hd, d), dtype,
                         fan_in=cfg.num_heads * hd),
    }


def resolve_window(cfg, layer_type: str, seq_len: int) -> int | None:
    """Effective attention window for a layer type at a given seq_len."""
    if layer_type in ("swa", "local"):
        return cfg.window_size
    if layer_type == "global" and seq_len >= 262_144:
        return 8_192        # long-context fallback for global layers
    return None             # full attention


def cache_capacity(cfg, layer_type: str, seq_len: int) -> int:
    w = resolve_window(cfg, layer_type, seq_len)
    return min(seq_len, w) if w else seq_len


def chunked_causal_attention(
    q: Tensor,              # (B, S, KV, G, D)  grouped query heads
    k: Tensor,              # (B, S, KV, D)
    v: Tensor,              # (B, S, KV, D)
    *,
    window: int | None,
    chunk: int = 1024,
) -> Tensor:
    """Online-softmax causal attention over KV chunks -> (B, S, KV, G, D)."""
    B, S, KV, G, D = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"attention chunk {chunk}")
    dev = q.device
    qf = (q * D ** -0.5).to(q.dtype).float()
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, S, D), dtype=torch.float32, device=dev)
    for j in range(S // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kj)
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        rel = q_pos[:, None] - k_pos[None, :]
        bias = torch.where(rel >= 0, 0.0, NEG_INF)
        if window is not None:
            bias = bias + torch.where(rel < window, 0.0, NEG_INF)
        s = s + bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def decode_attention(
    q: Tensor,               # (B, 1, KV, G, D)
    cache_k: Tensor,         # (B, KV, C, D)
    cache_v: Tensor,         # (B, KV, C, D)
    positions: Tensor,       # (B,) current absolute position
    *,
    window: int | None,
    ring: bool,
) -> Tensor:
    C = cache_k.shape[2]
    D = q.shape[-1]
    s = torch.einsum("bqhgd,bhcd->bhgqc", (q * D ** -0.5).to(q.dtype).float(),
                     cache_k.float())                     # (B, KV, G, 1, C)
    idx = torch.arange(C, device=q.device)
    pos = positions[:, None]                              # (B, 1)
    if ring:
        # slot i holds absolute position  pos - ((pos - i) mod C)
        abs_pos = pos - torch.remainder(pos - idx[None, :], C)
    else:
        abs_pos = idx[None, :].expand(pos.shape[0], C)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > (pos - window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqc,bhcd->bqhgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    return out.to(q.dtype)


def attn_apply(
    p: dict,
    x: Tensor,                      # (B, S, d)
    *,
    cfg,
    layer_type: str,
    positions: Tensor,              # (B, S) eval/prefill; (B,) decode
    mode: str,                      # train | eval | prefill | decode
    cache: dict | None = None,
    seq_len_ctx: int,               # context length the cache is sized for
) -> tuple[Tensor, dict | None]:
    B, S, d = x.shape
    KV, Hq, D = cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    G = Hq // KV
    dt = x.dtype
    window = resolve_window(cfg, layer_type, seq_len_ctx)
    cap = cache_capacity(cfg, layer_type, seq_len_ctx)
    ring = cap < seq_len_ctx

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    pos2d = positions if positions.ndim == 2 else positions[:, None]
    q = rope(q, pos2d, cfg.rope_theta)
    k = rope(k, pos2d, cfg.rope_theta)
    qg = q.reshape(B, S, KV, G, D)

    new_cache = None
    if mode in ("train", "eval", "prefill"):
        out = chunked_causal_attention(qg, k, v, window=window)
        if mode == "prefill":
            kc = k.transpose(1, 2)                # (B, KV, S, D)
            vc = v.transpose(1, 2)
            if cap < S:
                kc, vc = kc[:, :, S - cap:], vc[:, :, S - cap:]
                # place absolute position p at slot p % cap
                perm = torch.remainder(
                    torch.arange(S - cap, S, device=x.device), cap)
                inv = torch.argsort(perm)
                kc, vc = kc[:, :, inv], vc[:, :, inv]
            elif cap > S:
                pad = (0, 0, 0, cap - S)
                kc = torch.nn.functional.pad(kc, pad)
                vc = torch.nn.functional.pad(vc, pad)
            new_cache = {"k": kc.to(dt).contiguous(),
                         "v": vc.to(dt).contiguous()}
    elif mode == "decode":        # S == 1
        if cache is None:
            raise ValueError("decode needs a cache")
        slot = torch.remainder(positions, cap) if ring else positions
        b_idx = torch.arange(B, device=x.device)
        cache["k"][b_idx, :, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][b_idx, :, slot] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(qg, cache["k"], cache["v"], positions,
                               window=window, ring=ring)
        new_cache = cache
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    out = out.reshape(B, S, Hq, D)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return y, new_cache


def init_attn_cache(cfg, layer_type: str, batch: int, seq_len_ctx: int,
                    dtype, device) -> dict:
    cap = cache_capacity(cfg, layer_type, seq_len_ctx)
    shape = (batch, cfg.num_kv_heads, cap, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
