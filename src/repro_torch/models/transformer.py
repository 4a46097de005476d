"""Decoder stack for the dense-attention architectures (counterpart of
the attention subset of ``repro.models.transformer``).

Parameters are ``{"embed", "final_norm", "layers": [block, ...]}`` with
one dict per layer, in layer order; the reference's scanned layout
(``groups[i]`` stacked over G, then ``tail``) maps onto it through
``repro_torch.interop.params_from_jax``. The layers run in a Python
loop where the reference uses ``lax.scan``.

Monitoring (paper §4.6 in the serving path): with
``SketchSettings.serve_monitor``, every layer's residual-stream output
feeds that layer's "res" EMA triple in prefill and decode. The nodes
have no consumer, so the generated tokens do not depend on them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_apply, embed_init, mlp_apply, mlp_init, rmsnorm_apply,
    rmsnorm_init, unembed_apply,
)
from repro_torch.sketches import NodeTree, SketchNode, proj_triple_update

Tensor = torch.Tensor
ATTN_KINDS = ("full", "swa", "local", "global")


@dataclasses.dataclass(frozen=True)
class SketchSettings:
    """Sketch hyper-parameters of the serving monitor."""
    beta: float = 0.95
    # monitoring-only "res" nodes update in prefill/decode (never eval)
    serve_monitor: bool = False


def _check_ported(cfg: ArchConfig) -> None:
    kinds = set(cfg.pattern)
    if not kinds <= set(ATTN_KINDS) or cfg.mlp_type == "none":
        raise NotImplementedError(
            f"{cfg.name}: only dense-attention blocks with a dense MLP are "
            f"ported (pattern {cfg.pattern}, mlp {cfg.mlp_type!r}); the "
            f"others are ROADMAP A13")


def _block_init(gen, cfg: ArchConfig, dtype) -> dict:
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": attn.attn_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights in ``cfg.param_dtype`` on the generator's device."""
    _check_ported(cfg)
    dtype = cfg.param_dtype
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            cfg.tie_embeddings),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "layers": [_block_init(gen, cfg, dtype)
                   for _ in range(cfg.num_layers)],
    }


def cast_params(params, dtype, device):
    """The same nested dict with every tensor on ``device`` in ``dtype``
    (the forward casts weights to its compute dtype at each use; a copy
    cast once gives the same values)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype, device) for v in params]
    return params.to(device=device, dtype=dtype)


def init_cache(cfg: ArchConfig, batch: int, seq_len_ctx: int,
               device) -> list[dict]:
    """One {"k", "v"} cache per layer, sized for ``seq_len_ctx``."""
    return [attn.init_attn_cache(cfg, kind, batch, seq_len_ctx, cfg.dtype,
                                 device)
            for kind in cfg.layer_types]


def _monitor_active(mode: str, st: SketchSettings) -> bool:
    """Whether monitoring-only sketch nodes advance in this mode."""
    return st.serve_monitor and mode in ("prefill", "decode")


def _apply_block(kind, p, x, *, cfg, positions, mode, cache, seq_len_ctx):
    """One decoder block. Returns (x, new_cache)."""
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    mix, new_cache = attn.attn_apply(
        p["attn"], h, cfg=cfg, layer_type=kind, positions=positions,
        mode=mode, cache=cache, seq_len_ctx=seq_len_ctx)
    x = x + mix
    h2 = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_type), new_cache


def forward(
    params: dict,
    tokens: Tensor,                 # (B, S) int
    *,
    cfg: ArchConfig,
    mode: str = "eval",             # eval | prefill | decode
    positions: Tensor | None = None,
    cache: list | None = None,
    sketch_state: NodeTree | None = None,
    settings: SketchSettings = SketchSettings(),
    logits_only_last: bool = False,
    seq_len_ctx: int | None = None,
) -> dict:
    """Full decoder forward -> dict(logits, cache, sketch_state).

    ``seq_len_ctx`` is the context length caches are sized for (decode
    must pass it; eval and prefill default to S). Under an active
    monitor, layer l's output (B*S, d) updates ``res`` entry l and the
    returned tree has its step advanced; otherwise the tree comes back
    as given.
    """
    _check_ported(cfg)
    B, S = tokens.shape
    dt = cfg.dtype
    d = cfg.d_model
    if positions is None:
        positions = torch.arange(S, dtype=torch.long,
                                 device=tokens.device).expand(B, S)
    x = embed_apply(params["embed"], tokens, dt)
    x = x * torch.tensor(d ** 0.5, dtype=dt, device=x.device)
    if seq_len_ctx is None:
        seq_len_ctx = S
    monitor = (sketch_state is not None and "res" in sketch_state.nodes
               and _monitor_active(mode, settings))
    if monitor:
        res = sketch_state.nodes["res"]
        k_active = sketch_state.k_active
        new_res = ([], [], [])

    new_cache = [] if mode in ("prefill", "decode") else None
    for l, kind in enumerate(cfg.layer_types):
        x, nc = _apply_block(
            kind, params["layers"][l], x, cfg=cfg, positions=positions,
            mode=mode, cache=cache[l] if cache is not None else None,
            seq_len_ctx=seq_len_ctx)
        if new_cache is not None:
            new_cache.append(nc)
        if monitor:
            upd = proj_triple_update(
                res.x[l], res.y[l], res.z[l], x.reshape(B * S, d),
                sketch_state.proj, res.psi[l], settings.beta, k_active)
            for acc, t in zip(new_res, upd):
                acc.append(t)

    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if logits_only_last:
        x = x[:, -1:]
    logits = unembed_apply(params["embed"], x, dt)

    new_sketch = sketch_state
    if monitor:  # the reference stacks "res" in layer order too
        xs, ys, zs = (torch.stack(t) for t in new_res)
        node = SketchNode(x=xs, y=ys, z=zs, psi=res.psi)
        new_sketch = dataclasses.replace(
            sketch_state, nodes=dict(sketch_state.nodes, res=node),
            step=sketch_state.step + 1)
    return {"logits": logits, "cache": new_cache, "sketch_state": new_sketch}
