"""Mixture-of-Experts FFN: top-k routing and capacity dispatch on one
device (counterpart of the single-device path of ``repro.models.moe``).

Dispatch is sort-based: the T*K (token, choice) assignments are sorted
stably by expert, each takes its position among its expert's, and the
first C of an expert fill its C slots; later ones are dropped (drop
late). The experts run as batched products over their (E, C, d) slabs,
as the reference computes them with ``jnp.einsum`` outside any Pallas
kernel. The combine gathers each token's K slot outputs and sums them
with one batched product, where the reference scatter-adds the slots
into the tokens: the same sum up to its order, and the same bits on
every run (no atomics). Nothing is read back to the host, so a step's
launches queue ahead of the card.

The routing matches the reference's exactly: ``jax.lax.top_k`` breaks a
tie of probabilities to the lower expert, and so does a stable
descending sort, where ``torch.topk`` promises no order among ties.

The reference's shard_map path (expert or tensor parallel) is ROADMAP
A14.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, E), dtype),
        "we_gate": dense_init(gen, (E, d, f), dtype, fan_in=d),
        "we_up": dense_init(gen, (E, d, f), dtype, fan_in=d),
        "we_down": dense_init(gen, (E, f, d), dtype, fan_in=f),
    }


def capacity(tokens_local: int, num_experts: int, k: int,
             capacity_factor: float) -> int:
    """Slots an expert: ceil(T K cf / E), a multiple of 4, at least 4."""
    c = math.ceil(tokens_local * k * capacity_factor / num_experts)
    return max(4, -(-c // 4) * 4)


def route(x: Tensor, router_w: Tensor, k: int):
    """(probs (T, E) f32, topw (T, k) renormalised, tope (T, k) int64):
    the k most probable experts of each token, ties to the lower one."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = srt[:, :k], idx[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, tope


def dispatch_meta(tope: Tensor, E: int, C: int):
    """Sort-based slot assignment of the (T, K) choices ``tope``.

    Returns tok (E*C,) the source token of each slot (0 where empty),
    valid (E*C,) bool, and slot (T, K): the slot of each choice, or E*C
    where it was dropped past its expert's capacity (the reference's
    out-of-range bin). Each expert's first position among the sorted
    choices comes from a binary search, so nothing is read back to the
    host."""
    T, K = tope.shape
    dev = tope.device
    n = T * K
    se, order = torch.sort(tope.reshape(-1), stable=True)
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(n, device=dev) - starts[se]
    slot_sorted = torch.where(pos < C, se * C + pos, E * C)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    # the choice in each slot; one slot past the end takes every dropped
    # choice and is cut off
    src = torch.full((E * C + 1,), n, dtype=torch.long, device=dev)
    src[slot_sorted] = order
    src = src[:E * C]
    valid = src < n
    tok = torch.where(valid, torch.div(src, K, rounding_mode="floor"), 0)
    return tok, valid, slot.reshape(T, K)


def _expert_ffn(xg: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """xg (E, C, d) -> (E, C, d) through the experts' swiglu FFNs."""
    dt = xg.dtype
    g = torch.bmm(xg, wg.to(dt))
    u = torch.bmm(xg, wu.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.bmm(h, wd.to(dt))


def aux_load_balance(probs: Tensor, tope: Tensor, E: int) -> Tensor:
    """Switch/GShard load-balance loss: E * sum(frac_routed * mean_prob)."""
    T, K = tope.shape
    me = probs.mean(dim=0)
    ones = torch.ones(T * K, dtype=probs.dtype, device=probs.device)
    ce = torch.zeros(E, dtype=probs.dtype, device=probs.device).index_add_(
        0, tope.reshape(-1), ones) / (T * K)
    return E * torch.sum(me * ce)


def moe_apply_ref(p: dict, x: Tensor, cfg, *, return_dispatch=False):
    """x (T, d) -> (y (T, d), aux ()); with ``return_dispatch`` also the
    dispatched input xg (E, C, d), dropped and empty slots zero rows:
    the activation the "expert_in" nodes sketch."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(T, E, K, cfg.capacity_factor)
    probs, topw, tope = route(x, p["router"], K)
    tok, valid, slot = dispatch_meta(tope, E, C)
    xg = (x[tok] * valid[:, None].to(x.dtype)).reshape(E, C, d)
    out = _expert_ffn(xg, p["we_gate"], p["we_up"], p["we_down"])
    # a zero row past the slots for the dropped choices; each token's K
    # slot outputs gathered and summed in one batched product, weighted
    # as the reference weights them, in the compute type
    out = torch.cat([out.reshape(E * C, d), out.new_zeros(1, d)])
    w = (topw * (slot < E * C)).to(x.dtype)
    y = torch.bmm(w.unsqueeze(1), out[slot]).squeeze(1)
    aux = aux_load_balance(probs, tope, E)
    if return_dispatch:
        return y, aux, xg
    return y, aux


def moe_dense_ref(p: dict, x: Tensor, cfg) -> Tensor:
    """Oracle: every expert on every token, combined by the top-k
    weights (no capacity drops)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    probs, topw, tope = route(x, p["router"], K)
    cw = torch.zeros_like(probs).scatter_add(1, tope, topw)
    outs = _expert_ffn(x.expand((E,) + x.shape), p["we_gate"], p["we_up"],
                       p["we_down"])                       # (E, T, d)
    return torch.einsum("etd,te->td", outs, cw.to(x.dtype))


def moe_apply(p: dict, x: Tensor, cfg, *, return_dispatch=False):
    """x (B, S, d) -> (y (B, S, d), aux ()) [, xg (E, C, d)]: the
    single-device path over the B*S tokens."""
    B, S, d = x.shape
    out = moe_apply_ref(p, x.reshape(B * S, d), cfg,
                        return_dispatch=return_dispatch)
    return (out[0].reshape(B, S, d),) + tuple(out[1:])
