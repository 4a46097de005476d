"""Batched serving engine: prefill + decode over fixed request slots,
with slot refill for continuous batching (counterpart of
``repro.serve.engine``).

Live activation monitoring (paper §4.6 in the serving path): with
``monitor=True`` every prefill, decode and refill step updates one EMA
sketch of each layer's residual stream ("res" nodes of a monitor-mode
``NodeTree``, through the fused ``sketch_update`` kernel on CUDA),
records the tree's metrics in a ring buffer, and keeps a per-slot
activation-energy EMA for flagging degenerate requests. The sketches
have no consumer, so the generated tokens equal the unmonitored
engine's. Telemetry drains on the host into the schema shared with the
JAX package.

The engine runs on CUDA unless ``device`` says otherwise; without CUDA
it raises rather than fall back to the CPU. Attention caches are updated
in place (recurrentgemma's local layers: rings of window-size slots);
recurrent ones (xlstm's mLSTM and sLSTM state, recurrentgemma's RG-LRU
state: "r_h" in f32 and the conv tail "conv" in the compute type) are
replaced each step, and a refill writes every cache entry of its slot. Archs with
mLSTM blocks prefill prompts of at most one 256-token chunk or a whole
number of chunks; other lengths raise ``ValueError`` before any work.
``max_context`` bounds every arch's sequence, xlstm's too, though its
caches do not grow with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.monitor import (
    MonitorState, PathologyThresholds, detect_pathologies,
    init_monitor_state, monitor_record, tree_metrics,
)
from repro_torch.core.sketch import validate_proj_kind
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    SketchSettings, cast_params, check_seq_len, forward,
)
from repro_torch.sketches import (
    NodeSpec, NodeTree, gaussian_projections, init_node_tree,
    init_psparse_projections, node_paths, proj_num_tokens, proj_to,
    tree_to,
)
from repro_torch.telemetry import (
    TelemetryRecord, flag_paths, latest_reading, node_metrics, span,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class ServeMonitorState:
    """All monitoring state of one engine."""

    tree: Any               # monitor-mode NodeTree ("res" nodes, L layers);
    #                         proj sized for the DECODE token count (B) —
    #                         prefill/refill swap in their own projections
    ring: MonitorState      # (window, L, 3) tree_metrics ring buffer
    slot_ema: Tensor        # (B,) f32 per-slot activation-energy EMA
    slot_steps: Tensor      # (B,) int readings since the slot's (re)fill


def _slot_energy(logits: Tensor) -> Tensor:
    """(B,) activation-energy proxy from the last-position logits."""
    return torch.linalg.vector_norm(logits[:, -1].float(), dim=-1)


def _monitor_update(mon: ServeMonitorState, new_tree, logits, *,
                    beta: float) -> ServeMonitorState:
    """Fold one step's observations into the monitor state: ring-record
    the tree metrics and advance every slot's energy EMA."""
    energy = _slot_energy(logits)
    ema = torch.where(mon.slot_steps == 0, energy,
                      beta * mon.slot_ema + (1.0 - beta) * energy)
    return ServeMonitorState(
        tree=new_tree,
        ring=monitor_record(mon.ring, tree_metrics(new_tree)),
        slot_ema=ema,
        slot_steps=mon.slot_steps + 1,
    )


def detect_slot_pathologies(
    mon: ServeMonitorState,
    th: PathologyThresholds = PathologyThresholds(),
) -> dict[str, Tensor]:
    """Boolean (B,) per-slot flags from the energy EMA. A slot gates on
    its own fill counter (reset by refill), so a fresh slot cannot flag
    before its window warms up."""
    warmed = mon.slot_steps >= th.min_fill
    return {
        "slot_vanishing": warmed & (mon.slot_ema < th.vanish_norm),
        "slot_exploding": warmed & (mon.slot_ema > th.explode_norm),
    }


def prefill_step(params, tokens, mon, prefill_proj, *, cfg, seq_len_ctx,
                 settings):
    """Prefill a (B, S0) batch -> (cache, next tokens, monitor state).
    ``mon``/``prefill_proj`` are None when monitoring is off;
    ``prefill_proj`` holds (B*S0, k) projections (the tree's are sized
    for decode)."""
    sk = None if mon is None else dataclasses.replace(mon.tree,
                                                      proj=prefill_proj)
    out = forward(params, tokens, cfg=cfg, mode="prefill",
                  seq_len_ctx=seq_len_ctx, logits_only_last=True,
                  sketch_state=sk, settings=settings)
    next_tok = torch.argmax(out["logits"][:, -1], dim=-1)
    new_mon = mon
    if mon is not None:
        tree = dataclasses.replace(out["sketch_state"], proj=mon.tree.proj)
        new_mon = _monitor_update(mon, tree, out["logits"],
                                  beta=settings.beta)
    return out["cache"], next_tok, new_mon


def decode_step(params, cache, tokens, positions, mon, *, cfg, seq_len_ctx,
                settings):
    """One decode step -> (cache, next tokens, logits, positions + 1,
    monitor state)."""
    sk = mon.tree if mon is not None else None
    out = forward(params, tokens, cfg=cfg, mode="decode",
                  positions=positions, cache=cache, seq_len_ctx=seq_len_ctx,
                  sketch_state=sk, settings=settings)
    next_tok = torch.argmax(out["logits"][:, -1], dim=-1)
    new_mon = mon
    if mon is not None:
        new_mon = _monitor_update(mon, out["sketch_state"], out["logits"],
                                  beta=settings.beta)
    return out["cache"], next_tok, out["logits"], positions + 1, new_mon


def refill_step(params, cache, tok, pos, mon, slot: int, prompt,
                refill_proj, *, cfg, seq_len_ctx, settings):
    """Prefill ONE new (1, S0) prompt and splice it into request slot
    ``slot`` (cache, next token, position, monitor state)."""
    sk = None if mon is None else dataclasses.replace(mon.tree,
                                                      proj=refill_proj)
    out = forward(params, prompt, cfg=cfg, mode="prefill",
                  seq_len_ctx=seq_len_ctx, logits_only_last=True,
                  sketch_state=sk, settings=settings)
    for layer, one in zip(cache, out["cache"]):
        for name in layer:
            layer[name][slot] = one[name][0]
    tok = tok.clone()
    tok[slot] = torch.argmax(out["logits"][0, -1])
    pos = pos.clone()
    pos[slot] = prompt.shape[1]
    new_mon = mon
    if mon is not None:
        # the shared tree keeps accumulating; the refilled slot's own
        # statistics restart so its warm-up gating holds
        tree = dataclasses.replace(out["sketch_state"], proj=mon.tree.proj)
        slot_ema = mon.slot_ema.clone()
        slot_ema[slot] = _slot_energy(out["logits"])[0]
        slot_steps = mon.slot_steps.clone()
        slot_steps[slot] = 1
        new_mon = ServeMonitorState(
            tree=tree, ring=monitor_record(mon.ring, tree_metrics(tree)),
            slot_ema=slot_ema, slot_steps=slot_steps)
    return cache, tok, pos, new_mon


@dataclasses.dataclass
class ServeEngine:
    """Greedy batched generation over fixed request slots, with optional
    sketch-native live monitoring.

    ``monitor_proj_kind="psparse"`` monitors through seeds-only
    p-sparsified projections (density ``monitor_proj_density``) and the
    ``psparse_update`` kernel instead of dense Gaussian ones and
    ``sketch_update``. ``projections`` ({n_tokens: {"upsilon","omega",
    "phi"}} or {n_tokens: PsparseProjections}) and ``initial_tree``
    inject the monitor's random state (a differential test feeds the
    JAX engine's); otherwise both are drawn from ``torch.Generator``s
    seeded from ``monitor_seed``.
    """

    cfg: ArchConfig
    params: dict
    max_context: int
    monitor: bool = False
    monitor_rank: int = 4
    monitor_window: int = 32
    monitor_beta: float = 0.9
    monitor_seed: int = 17
    monitor_proj_kind: str = "gaussian"   # "psparse": seeds-only
    monitor_proj_density: float = 0.1     # projections of this density
    thresholds: PathologyThresholds = PathologyThresholds()
    telemetry_log: Any = None           # telemetry.TelemetryLog | None
    device: Any = None                  # None -> "cuda"
    projections: dict | None = None
    initial_tree: NodeTree | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._settings = SketchSettings(beta=self.monitor_beta,
                                        serve_monitor=self.monitor)
        self._params = cast_params(self.params, self.cfg.dtype, self.device)
        validate_proj_kind(self.monitor_proj_kind)
        self._proj_cache = {n: proj_to(p, self.device)
                            for n, p in (self.projections or {}).items()}
        self._slots = None
        self._host_pos: list[int] = []
        self._decode_steps = 0
        self.spans: dict[str, float] = {}
        self.last_logits = None

    @property
    def _k_max(self) -> int:
        return 2 * self.monitor_rank + 1

    def _step_kw(self) -> dict:
        return dict(cfg=self.cfg, seq_len_ctx=self.max_context,
                    settings=self._settings)

    def _proj_for(self, n_tokens: int):
        """(n_tokens, k_max) projection triple, injected or drawn from a
        generator seeded by (monitor_seed, n_tokens), and cached per
        token count: prefill (B*S0), decode (B) and refill (S0). A
        psparse entry is 12 coefficients instead of 3 n_tokens x k_max
        floats."""
        if n_tokens not in self._proj_cache:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.monitor_seed * 1_000_003 + n_tokens)
            if self.monitor_proj_kind == "psparse":
                proj = init_psparse_projections(
                    gen, n_tokens, self._k_max, self.monitor_proj_density)
            else:
                proj = gaussian_projections(gen, n_tokens, self._k_max)
            self._proj_cache[n_tokens] = proj
        return self._proj_cache[n_tokens]

    def _init_monitor(self, batch: int) -> ServeMonitorState:
        L, d = self.cfg.num_layers, self.cfg.d_model
        if self.initial_tree is not None:
            tree = tree_to(self.initial_tree, self.device)
            res = tree.nodes["res"]
            rows = proj_num_tokens(tree.proj)
            if tuple(res.x.shape) != (L, d, self._k_max) or rows != batch:
                raise ValueError(
                    f"initial_tree has res {tuple(res.x.shape)} and "
                    f"{rows} projection rows; the engine needs "
                    f"{(L, d, self._k_max)} and {batch}")
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.monitor_seed)
            tree = init_node_tree(gen, {"res": NodeSpec(width=d, layers=L)},
                                  num_tokens=batch, k_max=self._k_max,
                                  proj_kind=self.monitor_proj_kind,
                                  proj_density=self.monitor_proj_density)
        tree.rank = torch.tensor(self.monitor_rank, dtype=torch.int32,
                                 device=self.device)
        return ServeMonitorState(
            tree=tree,
            ring=init_monitor_state(self.monitor_window, L, self.device),
            slot_ema=torch.zeros((batch,), dtype=torch.float32,
                                 device=self.device),
            slot_steps=torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device),
        )

    def _check_context(self, length: int) -> None:
        if length > self.max_context:
            raise ValueError(f"sequence of {length} tokens exceeds "
                             f"max_context={self.max_context}")

    def _check_prompt(self, length: int) -> None:
        self._check_context(length)
        check_seq_len(self.cfg, length)

    # -- slot lifecycle -----------------------------------------------

    def start(self, prompts: Tensor) -> Tensor:
        """Prefill a (B, S0) prompt batch into the B request slots;
        returns the (B,) first generated tokens."""
        prompts = torch.as_tensor(prompts).to(self.device, torch.long)
        B, S0 = prompts.shape
        self._check_prompt(S0)
        mon = proj = None
        if self.monitor:
            mon = self._init_monitor(B)
            proj = self._proj_for(B * S0)
        with span(self.spans, "prefill") as block:
            cache, tok, mon = prefill_step(self._params, prompts, mon, proj,
                                           **self._step_kw())
            block(tok)
        self._slots = {
            "cache": cache, "tok": tok, "mon": mon,
            "pos": torch.full((B,), S0, dtype=torch.long,
                              device=self.device),
        }
        self._host_pos = [S0] * B
        return tok

    def decode_step(self) -> Tensor:
        """One greedy decode step for every slot; returns (B,) tokens."""
        s = self._slots
        self._check_context(max(self._host_pos) + 1)
        cache, tok, logits, pos, mon = decode_step(
            self._params, s["cache"], s["tok"][:, None], s["pos"], s["mon"],
            **self._step_kw())
        s.update(cache=cache, tok=tok, pos=pos, mon=mon)
        self._host_pos = [p + 1 for p in self._host_pos]
        self._decode_steps += 1
        self.last_logits = logits
        return tok

    def refill(self, slot: int, prompt: Tensor) -> None:
        """Replace request slot ``slot`` with a new (S0,) prompt."""
        s = self._slots
        prompt = torch.as_tensor(prompt).to(self.device, torch.long)
        slot = int(slot)
        if not 0 <= slot < len(self._host_pos):
            raise ValueError(f"slot {slot} outside 0..{len(self._host_pos)-1}")
        self._check_prompt(prompt.shape[-1])
        proj = self._proj_for(prompt.shape[-1]) if self.monitor else None
        cache, tok, pos, mon = refill_step(
            self._params, s["cache"], s["tok"], s["pos"], s["mon"], slot,
            prompt[None, :], proj, **self._step_kw())
        s.update(cache=cache, tok=tok, pos=pos, mon=mon)
        self._host_pos[slot] = prompt.shape[-1]

    def generate(self, prompts: Tensor, max_new_tokens: int) -> Tensor:
        """prompts (B, S0) -> (B, max_new_tokens) greedy continuations."""
        toks = [self.start(prompts)]
        with span(self.spans, "decode") as block:
            for _ in range(max_new_tokens - 1):
                toks.append(self.decode_step())
            block(toks[-1])
        out = torch.stack(toks, dim=1)
        if self.telemetry_log is not None:
            self.telemetry_log.append(self.telemetry_record())
        return out

    # -- telemetry ----------------------------------------------------

    def telemetry_record(self) -> TelemetryRecord:
        """Drain the monitor state into the shared telemetry schema
        (kind="serve"). Works with monitoring off (scalars/spans only)
        and on a freshly started engine (no flags before data)."""
        scalars: dict[str, float] = {
            "decode_steps": float(self._decode_steps),
        }
        dt = self.spans.get("decode", 0.0)
        if dt > 0 and self._slots is not None and self._decode_steps:
            B = self._slots["tok"].shape[0]
            scalars["decode_tok_s"] = B * self._decode_steps / dt
        nodes: dict = {}
        flags: dict = {}
        if self.monitor and self._slots is not None:
            mon = self._slots["mon"]
            paths = node_paths(mon.tree)
            nodes = node_metrics(latest_reading(mon.ring), paths)
            flags = flag_paths(detect_pathologies(
                mon.ring, self._k_max, self.thresholds), paths)
            flags.update(flag_paths(
                detect_slot_pathologies(mon, self.thresholds),
                [f"slot/{i}" for i in range(mon.slot_ema.shape[0])]))
            scalars["sketch_step"] = float(mon.tree.step)
        return TelemetryRecord(
            kind="serve", step=self._decode_steps, scalars=scalars,
            nodes=nodes, flags=flags, spans=dict(self.spans))
