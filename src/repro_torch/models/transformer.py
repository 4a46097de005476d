"""Decoder stack for the dense-attention architectures, xlstm's
mLSTM/sLSTM blocks, recurrentgemma's RG-LRU blocks, the MoE FFNs of
qwen3-moe and mixtral, and internvl2's spliced patch embeddings
(counterpart of ``repro.models.transformer``).

Parameters are ``{"embed", "final_norm", "layers": [block, ...]}`` with
one dict per layer, in layer order; the reference's scanned layout
(``groups[i]`` stacked over G, then ``tail``) maps onto it through
``repro_torch.interop.params_from_jax``, and ``flat_paths`` gives the
order in which the reference's ``ravel_pytree`` lays it out. The layers
run in a Python loop where the reference uses ``lax.scan``.

Training (``mode="train"``, paper Algorithm 2): with sketch mode
"backprop", both FFN matmuls of every layer run through
``sketches.linear.sketched_matmul``, each node's EMA triple updated on
its activation (``ffn_in`` on the FFN input, ``ffn_h`` on the hidden
activation) just before it is consumed, so no FFN input is stored for
the backward. Sketch mode "monitor" updates monitoring-only "res"
nodes on every layer's output instead.

MoE archs (``models/moe.py``) in backprop mode sketch the attention
out-projection instead ("attn_o", Hq*D wide: the heads' outputs after
the flash kernels feed ``sketched_matmul``), since the experts' routed
sub-batches break the fixed batch projection the sketched backward
needs; each layer's dispatched expert inputs (E, C, d) feed the
monitoring-only "expert_in" node, an (E, d, k) stack a layer, updated
in one stacked kernel launch against the projections' first C rows
(slabs longer than the binding T are cut to T: an expert's occupied
slots are its first ones). ``forward`` returns the layers' summed
load-balance losses as ``aux``.

Monitoring (paper §4.6 in the serving path): with
``SketchSettings.serve_monitor``, every layer's residual-stream output
feeds that layer's "res" EMA triple in prefill and decode. The nodes
have no consumer, so the generated tokens do not depend on them.

Recurrent blocks (``models/ssm.py``, ``models/rglru.py``) run in every
mode; a block with ``mlp_type="none"`` has no FFN. In train mode an arch
with mLSTM blocks also sketches each mLSTM layer's end-of-sequence
matrix memory: the carry nodes "mlstm_c" (C, H*dk*dv wide) and "mlstm_n"
(n, H*dk), stacked over the mLSTM layers only, in layer order (the
reference's group-major stack); one with RG-LRU blocks each RG-LRU
layer's end-of-sequence state, "rglru_h" (lru wide). Their B rows are
contracted against the projections' first B token rows
(``sketches.update.limit_rows``), which is the reference's zero-padded
update without the pad.

The updated tree is written into one new (L, w, k) buffer per node and
leaf as the layers go; the old tree stays whole, since the NaN guard
may keep it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sketch import validate_proj_kind
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import rglru
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed_apply, embed_init, mlp_apply, mlp_init, rmsnorm_apply,
    rmsnorm_init, unembed_apply,
)
from repro_torch.optim.flat import leaf_paths
from repro_torch.sketches import (
    NodeSpec, NodeTree, SketchNode, init_node_tree, proj_triple_increment,
    proj_triple_update,
)
from repro_torch.sketches.update import limit_rows, proj_num_tokens
from repro_torch.sketches.linear import sketched_matmul
from repro_torch.sketches.registry import (
    RECURRENT_KINDS, node_specs_for, register_node_specs,
)

Tensor = torch.Tensor
ATTN_KINDS = ("full", "swa", "local", "global")
# the leaves the reference casts to f32, not to the compute type, at use
F32_LEAVES = ("b_gates", "b_s", "r_s", "a_param", "w_input_gate",
              "w_rec_gate")
#: carry node -> the block kind whose layers update it; every other node
#: updates at every layer
CARRY_NODE_KINDS = {
    "mlstm_c": "mlstm",       # matrix memory C, flattened H*dk*dv
    "mlstm_n": "mlstm",       # normaliser n, flattened H*dk
    "rglru_h": "rglru",       # RG-LRU state h, lru wide
}
#: the nodes that sketched backprop consumes in train mode
CONSUMED_NODES = ("ffn_in", "ffn_h", "attn_o")


@dataclasses.dataclass(frozen=True)
class SketchSettings:
    """Static sketching hyper-parameters of the forward."""
    enabled: bool = False
    beta: float = 0.95
    k_max: int = 33                 # 2*r_max+1
    recon_mode: str = "fast"        # faithful | fast
    ridge: float = 1e-4             # relative ridge (core.reconstruct)
    factored: bool = True           # low-rank weight-gradient products
    proj_kind: str = "gaussian"     # gaussian | psparse
    proj_density: float = 0.1       # psparse nonzero fraction p
    # the data-parallel layouts (train.step): per-node psums
    # (``dp_axis``, run by the step as the phases below), deferred
    # increments (``dp_defer``: the forward emits each node's local
    # (1-beta)-scaled increments and consumes the incoming tree, merged
    # through the previous step) and a pre-merged tree (``dp_premerged``:
    # the forward consumes the tree as given and emits nothing)
    dp_axis: str | None = None
    dp_defer: bool = False
    dp_premerged: bool = False
    # monitoring-only "res" nodes update in prefill/decode (never eval)
    serve_monitor: bool = False

    def __post_init__(self):
        validate_proj_kind(self.proj_kind)
        if self.dp_defer and self.dp_axis is not None:
            raise ValueError(
                "SketchSettings.dp_defer (fused one-psum step) and "
                "dp_axis (per-node psum inside the forward) are "
                "mutually exclusive collective layouts")
        if self.dp_premerged and (self.dp_defer or
                                  self.dp_axis is not None):
            raise ValueError(
                "SketchSettings.dp_premerged consumes an already-merged "
                "tree: it excludes both dp_defer (increment emission) "
                "and dp_axis (per-node psums inside the forward)")
        if self.serve_monitor and (self.dp_defer or self.dp_premerged
                                   or self.dp_axis is not None):
            raise ValueError(
                "SketchSettings.serve_monitor is the single-program "
                "serving path: it excludes the DP training layouts "
                "(dp_axis / dp_defer / dp_premerged)")


def sketch_groups(cfg: ArchConfig) -> dict[str, int]:
    """{node name: width} of the sketched activation nodes: "res" in
    monitor mode, else "ffn_in" and "ffn_h", or for MoE "attn_o" and
    "expert_in"; in either mode, with mLSTM blocks the carry nodes
    "mlstm_c" and "mlstm_n", with RG-LRU blocks "rglru_h"."""
    if cfg.sketch_mode == "none":
        return {}
    if cfg.sketch_mode == "monitor":
        groups = {"res": cfg.d_model}
    elif cfg.is_moe:
        groups = {"attn_o": cfg.num_heads * cfg.resolved_head_dim,
                  "expert_in": cfg.d_model}
    else:
        groups = {"ffn_in": cfg.d_model}
        if cfg.mlp_type in ("swiglu", "gelu"):
            groups["ffn_h"] = cfg.d_ff
    if "mlstm" in cfg.pattern:
        _, H, dk, dv = ssm.mlstm_dims(cfg)
        groups["mlstm_c"] = H * dk * dv
        groups["mlstm_n"] = H * dk
    if "rglru" in cfg.pattern:
        groups["rglru_h"] = rglru.lru_dim(cfg)
    return groups


def node_layers(name: str, cfg: ArchConfig) -> list[int]:
    """The layers that update node ``name``, in the order of its stack:
    every layer, or for a carry node the layers of its kind."""
    kind = CARRY_NODE_KINDS.get(name)
    return [l for l, k in enumerate(cfg.layer_types)
            if kind is None or k == kind]


def node_layer_count(cfg: ArchConfig, name: str) -> int:
    """Stacked entries of node ``name``."""
    return len(node_layers(name, cfg))


def transformer_node_specs(cfg: ArchConfig) -> dict[str, NodeSpec]:
    """One NodeSpec per node group, stacked over the layers that update
    it; "expert_in" stacks (layers, experts)."""
    specs = {}
    for g, w in sketch_groups(cfg).items():
        n = node_layer_count(cfg, g)
        specs[g] = NodeSpec(width=w, layers=(n, cfg.num_experts)
                            if g == "expert_in" else n)
    return specs


# one spec function serves the three transformer-stack families
register_node_specs("lm", transformer_node_specs)
register_node_specs("moe", transformer_node_specs)
register_node_specs("recurrent", transformer_node_specs)


def init_lm_sketch_state(gen: torch.Generator, cfg: ArchConfig,
                         st: SketchSettings,
                         num_tokens: int) -> NodeTree | None:
    """The LM's NodeTree: per-group (L, w, k_max) stacked nodes, shared
    (num_tokens, k_max) projections, full rank; None when sketching is
    off. Drawn on the generator's device."""
    if not st.enabled:
        return None
    return init_node_tree(gen, node_specs_for(cfg), num_tokens,
                          st.k_max, dtype=torch.float32,
                          proj_kind=st.proj_kind,
                          proj_density=st.proj_density)


def check_seq_len(cfg: ArchConfig, S: int) -> None:
    """Raises ValueError unless every block kind of ``cfg`` can prefill
    S tokens at once (mLSTM: ``ssm.check_prompt_len``)."""
    if "mlstm" in cfg.pattern:
        ssm.check_prompt_len(S)


def _check_ported(cfg: ArchConfig) -> None:
    kinds = set(cfg.pattern)
    if not kinds <= set(ATTN_KINDS + RECURRENT_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention, mLSTM, sLSTM and "
            f"RG-LRU blocks (pattern {cfg.pattern}); block kinds "
            f"{sorted(kinds - set(ATTN_KINDS + RECURRENT_KINDS))} have no "
            f"port")


def _block_init(gen, cfg: ArchConfig, kind: str, dtype) -> dict:
    dev = gen.device
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.attn_init(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mix"] = ssm.mlstm_init(gen, cfg, dtype)
    elif kind == "rglru":
        p["mix"] = rglru.rglru_init(gen, cfg, dtype)
    else:
        p["mix"] = ssm.slstm_init(gen, cfg, dtype)
    if cfg.is_moe:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["moe"] = moe.moe_init(gen, cfg, dtype)
    elif cfg.mlp_type != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights in ``cfg.param_dtype`` on the generator's device."""
    _check_ported(cfg)
    dtype = cfg.param_dtype
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            cfg.tie_embeddings),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
        "layers": [_block_init(gen, cfg, kind, dtype)
                   for kind in cfg.layer_types],
    }


def num_params(cfg: ArchConfig) -> int:
    """Parameters of ``init_params(gen, cfg)``, counted from the config
    without allocating them."""
    _check_ported(cfg)
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    inner, _, dk, _ = ssm.mlstm_dims(cfg)
    lru = rglru.lru_dim(cfg)
    mix = {"mlstm": 3 * d * inner + 2 * inner * H * dk + 2 * inner * H
           + 2 * H + cfg.conv_width * inner,
           "slstm": 5 * d * d + 4 * d * (d // H) + 4 * d,
           "rglru": 3 * d * lru + 2 * lru * lru + (cfg.conv_width + 2) * lru}
    attn_w = 2 * d * H * hd + 2 * d * cfg.num_kv_heads * hd
    mlp_w = 0 if cfg.mlp_type == "none" else \
        (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff + d
    if cfg.is_moe:          # router, three expert stacks, norm2
        E = cfg.num_experts
        mlp_w = d * E + 3 * E * d * cfg.d_ff + d
    embed = (1 if cfg.tie_embeddings else 2) * cfg.vocab_size * d
    return embed + d + sum(mix.get(kind, attn_w) + mlp_w + d
                           for kind in cfg.layer_types)


def num_reference_leaves(cfg: ArchConfig) -> int:
    """``len(reference_leaves(init_params(gen, cfg), cfg))``, counted from
    the config without allocating the parameters: the embedding's leaves
    (and the untied head's), the final norm's, then each block's norm1,
    mixer and, with an MLP, norm2 and its weights (an MoE FFN's router
    and three expert stacks), once a pattern position (stacked over the
    groups) and once a tail layer."""
    _check_ported(cfg)
    P, G = len(cfg.pattern), cfg.num_groups
    mlp = 5 if cfg.is_moe else \
        {"none": 0, "swiglu": 4, "gelu": 3}[cfg.mlp_type]
    mix = {"mlstm": 8, "slstm": 4, "rglru": 8}
    kinds = cfg.layer_types[:P] if G else ()
    kinds = [*kinds, *cfg.layer_types[G * P:]]
    return (1 if cfg.tie_embeddings else 2) + 1 + sum(
        1 + mix.get(kind, 4) + mlp for kind in kinds)


def reference_leaves(params: dict, cfg: ArchConfig) -> list[list[tuple]]:
    """The reference's parameter leaves, in the order
    ``jax.flatten_util.ravel_pytree`` lays out its stacked tree, each as
    the list of the port's leaf paths it holds: sorted keys ("embed",
    "final_norm", "groups", "tail"); for pattern position i, each block
    leaf of layers i, P+i, 2P+i, ... (a (G, ...) stacked leaf); then the
    tail layers' leaves one by one."""
    P, G = len(cfg.pattern), cfg.num_groups
    layers = params["layers"]
    out = [[("embed",) + p] for p in leaf_paths(params["embed"])]
    out += [[("final_norm",) + p] for p in leaf_paths(params["final_norm"])]
    for i in range(P if G else 0):
        out += [[("layers", g * P + i) + p for g in range(G)]
                for p in leaf_paths(layers[i])]
    for t in range(G * P, len(layers)):
        out += [[("layers", t) + p] for p in leaf_paths(layers[t])]
    return out


def flat_paths(params: dict, cfg: ArchConfig) -> list[tuple]:
    """The port's leaf paths in the reference's flat order."""
    return [p for leaf in reference_leaves(params, cfg) for p in leaf]


def cast_params(params, dtype, device):
    """The same nested dict with every tensor on ``device`` in ``dtype``,
    but the ``F32_LEAVES`` in float32 (the forward casts weights to its
    compute dtype at each use, those to f32; a copy cast once gives the
    same values)."""
    if isinstance(params, dict):
        return {k: cast_params(v, torch.float32 if k in F32_LEAVES
                               else dtype, device)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype, device) for v in params]
    return params.to(device=device, dtype=dtype)


def _block_cache(cfg: ArchConfig, kind: str, batch: int, seq_len_ctx: int,
                 device) -> dict:
    if kind in ATTN_KINDS:
        return attn.init_attn_cache(cfg, kind, batch, seq_len_ctx, cfg.dtype,
                                    device)
    if kind == "mlstm":
        return ssm.init_mlstm_cache(cfg, batch, cfg.dtype, device)
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, cfg.dtype, device)
    return ssm.init_slstm_cache(cfg, batch, cfg.dtype, device)


def init_cache(cfg: ArchConfig, batch: int, seq_len_ctx: int,
               device) -> list[dict]:
    """One cache per layer, by block kind: {"k", "v"} sized for
    ``seq_len_ctx``, mLSTM's {"C", "m_n", "m_m", "conv"}, sLSTM's
    {"s_c", "s_n", "s_m", "s_h"} or RG-LRU's {"r_h", "conv"}."""
    return [_block_cache(cfg, kind, batch, seq_len_ctx, device)
            for kind in cfg.layer_types]


def _monitor_active(mode: str, st: SketchSettings) -> bool:
    """Whether monitoring-only sketch nodes advance in this mode."""
    return mode == "train" or (st.serve_monitor
                               and mode in ("prefill", "decode"))


def _update_triple(node: SketchNode, a: Tensor, proj, k_active,
                   st: SketchSettings) -> tuple[SketchNode, SketchNode]:
    """One layer's node on activation ``a`` (T, d): (the node the layer
    consumes, the node it emits). Plainly both are the updated node;
    under ``dp_defer`` the layer consumes the incoming node and emits its
    local increments; under ``dp_premerged`` both are the incoming
    node."""
    if st.dp_premerged:
        return node, node
    if st.dp_defer:
        ix, iy, iz = proj_triple_increment(node.x, node.y, node.z, a, proj,
                                           node.psi, st.beta, k_active)
        return node, SketchNode(x=ix, y=iy, z=iz, psi=node.psi)
    xs, ys, zs = proj_triple_update(node.x, node.y, node.z, a, proj,
                                    node.psi, st.beta, k_active)
    new = SketchNode(x=xs, y=ys, z=zs, psi=node.psi)
    return new, new


def _update_carry_triple(node: SketchNode, a: Tensor, proj, k_active,
                         st: SketchSettings) -> SketchNode:
    """A carry node's update on its B rows ``a`` (B, w): ``_update_triple``
    against the projections' first B token rows. The reference pads
    ``a`` with zero rows to the tree's binding instead, which adds
    nothing to any increment. Returns the emitted node; carry nodes have
    no consumer."""
    return _update_triple(node, a, limit_rows(proj, a.shape[0]), k_active,
                          st)[1]


def _apply_sketched_mlp(p, x, cfg, sk, proj, omega, k_active,
                        st: SketchSettings):
    """Dense FFN with sketched backprop on both matmuls; returns (y,
    {"ffn_in", "ffn_h"} emitted nodes of this layer)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    c_in, n_in = _update_triple(sk["ffn_in"], xf, proj, k_active, st)

    def mm(a, w, t):
        return sketched_matmul(a, w.to(a.dtype), t.x, t.y, t.z, omega,
                               k_active, st.recon_mode, st.ridge, st.factored)

    if cfg.mlp_type == "swiglu":
        g = mm(xf, p["w_gate"], c_in)
        u = mm(xf, p["w_up"], c_in)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(mm(xf, p["w_up"], c_in).float(),
                   approximate="tanh").to(x.dtype)
    c_h, n_h = _update_triple(sk["ffn_h"], h, proj, k_active, st)
    return mm(h, p["w_down"], c_h).reshape(B, S, d), {"ffn_in": n_in,
                                                      "ffn_h": n_h}


def _update_expert_triple(node: SketchNode, xg: Tensor, proj, k_active,
                          st: SketchSettings) -> SketchNode:
    """The "expert_in" stack's update on the dispatched slab xg (E,
    rows, d): one stacked kernel launch, each expert's triple against
    the projections' first rows. The reference zero-pads each expert's
    rows to the binding T and vmaps the update over E; the pad adds
    nothing. Past T it cuts the slab to T: slot positions count up from
    0 in each expert and a token's K experts differ, so an expert's
    occupied slots are its first, at most T, and the rest are zero.
    Returns the emitted node; the expert nodes have no consumer."""
    T = proj_num_tokens(proj)
    if xg.shape[1] > T:
        xg = xg[:, :T]
    return _update_triple(node, xg, limit_rows(proj, xg.shape[1]), k_active,
                          st)[1]


def _attn_with_sketch(p, h, *, cfg, layer_type, positions, seq_len_ctx,
                      node, proj, omega, k_active, st: SketchSettings):
    """Train-mode attention whose out-projection runs sketched backprop
    on the "attn_o" node (MoE archs): the heads' outputs (B*S, Hq*D)
    from the flash kernels update the node and feed ``sketched_matmul``.
    Returns (y, the emitted node)."""
    B, S, d = h.shape
    out, _ = attn.attn_heads(p, h, cfg=cfg, layer_type=layer_type,
                             positions=positions, mode="train",
                             seq_len_ctx=seq_len_ctx)
    flat = out.reshape(B * S, -1)
    c_node, n_node = _update_triple(node, flat, proj, k_active, st)
    wo = p["wo"].to(h.dtype).reshape(flat.shape[1], d)
    y = sketched_matmul(flat, wo, c_node.x, c_node.y, c_node.z, omega,
                        k_active, st.recon_mode, st.ridge, st.factored)
    return y.reshape(B, S, d), n_node


def _apply_block(kind, p, x, *, cfg, positions, mode, cache, seq_len_ctx,
                 sk=None, carry=None, proj=None, omega=None, k_active=None,
                 st: SketchSettings = SketchSettings()):
    """One decoder block. ``sk`` holds this layer's sketched-backprop
    and expert nodes in train mode, ``carry`` an mLSTM or RG-LRU layer's
    carry nodes. Returns (x, new_cache, new nodes, the MoE load-balance
    loss or None)."""
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    new_sk = {}
    if kind in ATTN_KINDS and sk and "attn_o" in sk:
        mix, new_sk["attn_o"] = _attn_with_sketch(
            p["attn"], h, cfg=cfg, layer_type=kind, positions=positions,
            seq_len_ctx=seq_len_ctx, node=sk["attn_o"], proj=proj,
            omega=omega, k_active=k_active, st=st)
        new_cache = None
    elif kind in ATTN_KINDS:
        mix, new_cache = attn.attn_apply(
            p["attn"], h, cfg=cfg, layer_type=kind, positions=positions,
            mode=mode, cache=cache, seq_len_ctx=seq_len_ctx)
    elif kind == "mlstm" and carry:
        mix, new_cache, (C, n) = ssm.mlstm_apply(
            p["mix"], h, cfg=cfg, mode=mode, cache=cache, return_carry=True)
        B = x.shape[0]
        new_sk = {name: _update_carry_triple(carry[name], t.reshape(B, -1),
                                             proj, k_active, st)
                  for name, t in (("mlstm_c", C), ("mlstm_n", n))}
    elif kind == "mlstm":
        mix, new_cache = ssm.mlstm_apply(p["mix"], h, cfg=cfg, mode=mode,
                                         cache=cache)
    elif kind == "rglru" and carry:
        mix, new_cache, h_end = rglru.rglru_apply(
            p["mix"], h, cfg=cfg, mode=mode, cache=cache, return_carry=True)
        new_sk = {"rglru_h": _update_carry_triple(carry["rglru_h"], h_end,
                                                  proj, k_active, st)}
    elif kind == "rglru":
        mix, new_cache = rglru.rglru_apply(p["mix"], h, cfg=cfg, mode=mode,
                                           cache=cache)
    else:
        mix, new_cache = ssm.slstm_apply(p["mix"], h, cfg=cfg, mode=mode,
                                         cache=cache)
    x = x + mix
    if cfg.is_moe:
        h2 = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if sk and "expert_in" in sk:
            y, aux, xg = moe.moe_apply(p["moe"], h2, cfg,
                                       return_dispatch=True)
            new_sk["expert_in"] = _update_expert_triple(
                sk["expert_in"], xg, proj, k_active, st)
        else:
            y, aux = moe.moe_apply(p["moe"], h2, cfg)
        return x + y, new_cache, new_sk, aux
    if cfg.mlp_type == "none":
        return x, new_cache, new_sk, None
    h2 = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if not sk or "ffn_in" not in sk:
        return (x + mlp_apply(p["mlp"], h2, cfg.mlp_type), new_cache,
                new_sk, None)
    y, mlp_sk = _apply_sketched_mlp(p["mlp"], h2, cfg, sk, proj, omega,
                                    k_active, st)
    return x + y, new_cache, {**new_sk, **mlp_sk}, None


def forward(
    params: dict,
    tokens: Tensor,                 # (B, S) int
    *,
    cfg: ArchConfig,
    mode: str = "eval",             # train | eval | prefill | decode
    positions: Tensor | None = None,
    cache: list | None = None,
    sketch_state: NodeTree | None = None,
    settings: SketchSettings = SketchSettings(),
    logits_only_last: bool = False,
    seq_len_ctx: int | None = None,
    patch_embeds: Tensor | None = None,
) -> dict:
    """Full decoder forward -> dict(logits, cache, aux, sketch_state).

    ``seq_len_ctx`` is the context length caches are sized for (decode
    must pass it; train, eval and prefill default to S). In train mode
    the "ffn_in"/"ffn_h" nodes of a backprop tree update and feed the
    sketched FFN (an MoE arch's "attn_o" the sketched out-projection, and
    its "expert_in" stacks update on the dispatched slabs), and each
    mLSTM layer updates its "mlstm_c"/"mlstm_n" entries and each RG-LRU
    layer its "rglru_h" entry; under an active monitor, layer l's output
    (B*S, d) updates "res" entry l. Whenever nodes update, the returned
    tree has its step advanced; otherwise it comes back as given.
    ``aux`` is the sum of the MoE layers' load-balance losses (0 without
    MoE). For a "vision" frontend, ``patch_embeds`` (B, f, d) replaces
    the scaled embeddings of positions [0, f) when f <= S (cast to
    ``cfg.dtype``; out of place, so those rows give the embedding no
    gradient); other frontends and f > S leave the embeddings as they
    are, as the reference does.
    """
    _check_ported(cfg)
    if settings.dp_axis is not None:
        raise ValueError(
            "SketchSettings.dp_axis: one worker's forward cannot psum "
            "across workers; train.step runs the per-node layout as a "
            "dp_defer sweep, the merge and a dp_premerged sweep")
    B, S = tokens.shape
    dt = cfg.dtype
    d = cfg.d_model
    if positions is None:
        positions = torch.arange(S, dtype=torch.long,
                                 device=tokens.device).expand(B, S)
    x = embed_apply(params["embed"], tokens, dt)
    x = x * torch.tensor(d ** 0.5, dtype=dt, device=x.device)
    if patch_embeds is not None and cfg.frontend == "vision":
        f = patch_embeds.shape[1]
        if f <= S:
            x = torch.cat([patch_embeds.to(dt), x[:, f:]], dim=1)
    if seq_len_ctx is None:
        seq_len_ctx = S
    nodes = sketch_state.nodes if sketch_state is not None else {}
    layer_nodes = CONSUMED_NODES + ("expert_in",)
    sketched = mode == "train" and any(n in nodes for n in CONSUMED_NODES)
    monitor = "res" in nodes and _monitor_active(mode, settings)
    carried = mode == "train" and any(name in nodes
                                      for name in CARRY_NODE_KINDS)
    per_layer = mode == "train" and any(n in nodes for n in layer_nodes)
    live = [name for name in nodes
            if (name in CARRY_NODE_KINDS and carried)
            or (name == "res" and monitor)
            or (name in layer_nodes and per_layer)]
    proj = k_active = omega = None
    if live:
        proj, k_active = sketch_state.proj, sketch_state.k_active
    if sketched:  # psparse materialises omega: once a step, not per layer
        omega = proj["omega"]
    # each live node's new (L, w, k) leaves, written entry by entry, and
    # the stack entry each layer updates
    new = {name: [torch.empty_like(getattr(nodes[name], a)) for a in "xyz"]
           for name in live}
    entry = {name: {l: i for i, l in enumerate(node_layers(name, cfg))}
             for name in live}

    def node_at(name, l):
        n, i = nodes[name], entry[name][l]
        return SketchNode(x=n.x[i], y=n.y[i], z=n.z[i], psi=n.psi[i])

    new_cache = [] if mode in ("prefill", "decode") else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, kind in enumerate(cfg.layer_types):
        sk = ({name: node_at(name, l) for name in layer_nodes
               if name in nodes} if per_layer else None)
        carry = ({name: node_at(name, l) for name in CARRY_NODE_KINDS
                  if l in entry.get(name, ())} if carried else None)
        x, nc, new_sk, layer_aux = _apply_block(
            kind, params["layers"][l], x, cfg=cfg, positions=positions,
            mode=mode, cache=cache[l] if cache is not None else None,
            seq_len_ctx=seq_len_ctx, sk=sk, carry=carry, proj=proj,
            omega=omega, k_active=k_active, st=settings)
        if layer_aux is not None:
            aux = aux + layer_aux
        if new_cache is not None:
            new_cache.append(nc)
        if monitor:
            new_sk["res"] = _update_triple(node_at("res", l),
                                           x.reshape(B * S, d), proj,
                                           k_active, settings)[1]
        for name, node in new_sk.items():
            for buf, t in zip(new[name], (node.x, node.y, node.z)):
                buf[entry[name][l]].copy_(t)

    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if logits_only_last:
        x = x[:, -1:]
    logits = unembed_apply(params["embed"], x, dt)

    new_sketch = sketch_state
    if live:
        new_nodes = dict(nodes)
        for name, (nx, ny, nz) in new.items():
            new_nodes[name] = SketchNode(x=nx, y=ny, z=nz,
                                         psi=nodes[name].psi)
        new_sketch = dataclasses.replace(sketch_state, nodes=new_nodes,
                                         step=sketch_state.step + 1)
    return {"logits": logits, "cache": new_cache, "aux": aux,
            "sketch_state": new_sketch}
