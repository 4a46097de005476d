"""GQA attention: causal / sliding-window attention over the whole
sequence (train/eval/prefill) + KV-cache decode (counterpart of
``repro.models.attention``).

Train, eval and prefill go through ``kernels.flash_attention``: the
Hopper forward and backward kernels on the card, their plain versions on
the CPU. Where the reference's chunked scan rounds P to the compute type
before P V, the kernel keeps P in f32, as the TPU kernel does; in f32 the
two agree. Decode stays plain PyTorch, as the reference computes it in
XLA: scores and softmax in f32 with a -1e30 mask, full caches and
ring-buffer windowed caches (swa/local layers, and global layers past
262k tokens). The decode step writes the new key/value into the cache in
place, where the reference returns an updated copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
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


def attn_apply(p: dict, x: Tensor, **kw) -> tuple[Tensor, dict | None]:
    """Attention with its out-projection: (y (B, S, d), new cache); the
    keywords are ``attn_heads``'."""
    out, new_cache = attn_heads(p, x, **kw)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, new_cache


def attn_heads(
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
    """Attention before its out-projection: (the heads' outputs (B, S,
    Hq, D), new cache)."""
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

    new_cache = None
    if mode in ("train", "eval", "prefill"):
        # (B, S, H, D) read through (B, H, S, D) views: no copy either way
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=window).transpose(1, 2)
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
        out = decode_attention(q.reshape(B, S, KV, G, D), cache["k"],
                               cache["v"], positions, window=window,
                               ring=ring)
        new_cache = cache
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    return out.reshape(B, S, Hq, D), new_cache


def init_attn_cache(cfg, layer_type: str, batch: int, seq_len_ctx: int,
                    dtype, device) -> dict:
    cap = cache_capacity(cfg, layer_type, seq_len_ctx)
    shape = (batch, cfg.num_kv_heads, cap, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
