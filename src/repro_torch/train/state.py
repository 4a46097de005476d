"""Train state and run configuration of the LM trainer (counterpart of
``repro.train.state``).

``RunConfig`` keeps the reference's fields and its one compatibility
matrix (``validate``): every invalid combination raises ``ConfigError``
naming the fields in conflict, as the reference's does. The data
-parallel step runs W workers in one process (``train.step``); what is
not ported, the reduce-scatter merge and a dp group over a tuple of mesh
axes, raises ``NotImplementedError`` naming ROADMAP A14.

The state holds the replicated quantities once (parameters, AdamW
moments, the sketch tree) and the per-worker ones stacked on a leading
(W, ...) axis: the count sketch's error feedback {u, v} and the int8
sketch wire's residual ledger ``opt["sketch_err"]``, which is also the
layout the checkpoints keep ("per_worker_v1").
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.adaptive import (
    AdaptiveConfig, AdaptiveState, init_adaptive_state,
)
from repro_torch.core.monitor import MonitorState, init_monitor_state
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    SketchSettings, init_lm_sketch_state, init_params, num_params,
    sketch_groups,
)
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.optim.compression import (
    CompressionConfig, init_error_feedback, resolve_countsketch,
)
from repro_torch.optim.flat import tree_map
from repro_torch.sketches import NodeTree, node_paths, tree_to
from repro_torch.core.sketch import PROJ_KINDS
from repro_torch.sketches.wire import tree_increment_leaves


class ConfigError(ValueError):
    """An invalid RunConfig field value: ``fields`` names the fields."""

    def __init__(self, fields: tuple[str, ...], message: str):
        self.fields = tuple(fields)
        super().__init__(message)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything the training step needs besides the architecture."""
    seq_len: int
    global_batch: int
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 1000
    aux_weight: float = 0.01          # MoE load-balance loss weight
    z_weight: float = 1e-4            # z-loss (logit drift control)
    sketch: SketchSettings = SketchSettings()
    adaptive: AdaptiveConfig | None = None
    compression: CompressionConfig | None = None
    monitor_window: int = 32
    nan_guard: bool = True
    # data parallelism (train.step): the worker axis' name (None: one
    # worker), its W workers, the collective layout ("fused": one flat
    # psum a step; "per_node": one psum a node leaf; "overlap": the
    # sketch merge before the backward, the gradient wire after), the
    # merge ("psum"; "reduce_scatter" is ROADMAP A14), the sketch
    # increments' wire dtype, the ring kernel in place of the psum, and
    # the p2 round beside the optimizer's dense pass
    dp_axis_name: str | tuple[str, ...] | None = None
    dp_workers: int = 1
    dp_collective: str = "fused"
    dp_merge: str = "psum"
    sketch_wire_dtype: str = "fp32"
    ring_wire: bool = False
    p2_overlap: bool = True

    def __post_init__(self):
        self.validate()

    def _field(self, name: str):
        obj = self
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    def _conflict(self, a: str, b: str, why: str):
        raise ConfigError(
            (a, b),
            f"RunConfig: {a}={self._field(a)!r} incompatible with "
            f"{b}={self._field(b)!r}: {why}")

    def validate(self, *, consumed: bool | None = None) -> None:
        """The reference's cross-field compatibility matrix: every invalid
        combination raises one ``ConfigError`` naming its fields. Run at
        construction; the one row that needs the architecture (a
        reduce_scatter merge of a sketched-backprop tree needs the
        overlap layout) checks again when ``make_train_step`` passes
        ``consumed``. A valid combination the port has not ported raises
        ``NotImplementedError`` naming ROADMAP A14."""
        if self.dp_workers < 1:
            raise ConfigError(
                ("dp_workers",),
                f"RunConfig: dp_workers={self.dp_workers!r} invalid: "
                f"must be >= 1")
        if self.dp_collective not in ("fused", "per_node", "overlap"):
            raise ConfigError(
                ("dp_collective",),
                f"RunConfig: dp_collective={self.dp_collective!r} "
                f"invalid: must be 'fused', 'per_node' or 'overlap'")
        if self.dp_merge not in ("psum", "reduce_scatter"):
            raise ConfigError(
                ("dp_merge",),
                f"RunConfig: dp_merge={self.dp_merge!r} invalid: must "
                f"be 'psum' or 'reduce_scatter'")
        if self.sketch_wire_dtype not in ("fp32", "int8"):
            raise ConfigError(
                ("sketch_wire_dtype",),
                f"RunConfig: sketch_wire_dtype="
                f"{self.sketch_wire_dtype!r} invalid: must be 'fp32' "
                f"or 'int8'")
        if self.sketch.proj_kind not in PROJ_KINDS:
            raise ConfigError(
                ("sketch.proj_kind",),
                f"RunConfig: sketch.proj_kind="
                f"{self.sketch.proj_kind!r} invalid: must be one of "
                f"{PROJ_KINDS}")
        if self.dp_workers > 1 and self.global_batch % self.dp_workers:
            self._conflict(
                "global_batch", "dp_workers",
                "the global batch must be divisible by the worker count")
        if self.sketch.dp_premerged:
            self._conflict(
                "sketch.dp_premerged", "dp_collective",
                "dp_premerged is internal to the overlap step's phase "
                "2 — select it with dp_collective='overlap', never "
                "directly")
        if self.sketch.dp_defer:
            if self.dp_collective not in ("fused", "overlap"):
                self._conflict(
                    "sketch.dp_defer", "dp_collective",
                    "a deferred forward emits raw increments that only "
                    "the flat-segment layouts (fused/overlap) ever merge")
            if self.dp_axis_name is None:
                self._conflict(
                    "sketch.dp_defer", "dp_axis_name",
                    "a deferred forward emits raw increments that only "
                    "the flat-segment DP psums ever merge — the "
                    "single-program step has none")
        if self.dp_merge == "reduce_scatter":
            if self.sketch.enabled and self.dp_axis_name is None:
                self._conflict(
                    "dp_merge", "dp_axis_name",
                    "the single-program path has no worker shards to "
                    "scatter over")
            if self.dp_collective == "per_node":
                self._conflict(
                    "dp_merge", "dp_collective",
                    "per_node merges inside the forward and cannot "
                    "scatter; reduce_scatter needs the flat-segment "
                    "layouts (fused/overlap)")
            if consumed and self.dp_collective != "overlap":
                self._conflict(
                    "dp_merge", "dp_collective",
                    "a sketched-backprop (consumed) tree requires "
                    "dp_collective='overlap': the fused layout consumes "
                    "the previous step's merged triple, which no worker "
                    "holds under the scattered layout")
        if self.sketch_wire_dtype == "int8":
            if self.dp_axis_name is None:
                self._conflict(
                    "sketch_wire_dtype", "dp_axis_name",
                    "int8 quantizes the cross-worker wire — it needs a "
                    "dp axis")
            if self.dp_collective == "per_node":
                self._conflict(
                    "sketch_wire_dtype", "dp_collective",
                    "int8 needs the flat-segment layouts (fused/overlap); "
                    "per_node psums per leaf inside the forward")
            if self.dp_merge != "psum":
                self._conflict(
                    "sketch_wire_dtype", "dp_merge",
                    "the int8 wire is defined for the psum merge; the "
                    "reduce_scatter tiles stay f32")
        if self.ring_wire:
            if self.dp_axis_name is None or \
                    not isinstance(self.dp_axis_name, str):
                self._conflict(
                    "ring_wire", "dp_axis_name",
                    "the ring runs on ONE logical ring — a single-axis "
                    "dp_axis_name (tuple supergroups and the "
                    "single-program case have no ring order)")
            if self.dp_collective == "per_node":
                self._conflict(
                    "ring_wire", "dp_collective",
                    "the ring carries the flat-segment buffer; per_node "
                    "has none")
            if self.dp_merge != "psum":
                self._conflict(
                    "ring_wire", "dp_merge",
                    "the ring replaces the psum merge; reduce_scatter "
                    "keeps its own schedule")
        if self.dp_merge == "reduce_scatter":
            raise NotImplementedError(
                "RunConfig.dp_merge='reduce_scatter' (the sharded sketch "
                "merge) is not ported yet: ROADMAP A14")
        if isinstance(self.dp_axis_name, tuple):
            raise NotImplementedError(
                f"RunConfig.dp_axis_name={self.dp_axis_name!r}: a dp "
                f"group over a tuple of mesh axes is not ported yet: "
                f"ROADMAP A14")


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    sketch: NodeTree | None
    adaptive: AdaptiveState
    monitor: MonitorState
    step: int = 0                     # optimizer steps taken
    skipped: int = 0                  # NaN-guard skips


def finalize_run(cfg, run: RunConfig) -> RunConfig:
    """Resolve the count-sketch geometry against the model's flat
    parameter dimension (``cs_cols`` auto-sized when None), raising on
    a geometry that compresses nothing. Idempotent."""
    if run.compression is None or run.compression.mode != "countsketch":
        return run
    return dataclasses.replace(run, compression=resolve_countsketch(
        run.compression, num_params(cfg), strict=True))


def init_train_state(seed: int, cfg, run: RunConfig, *, device=None,
                     params=None, sketch: NodeTree | None = None
                     ) -> TrainState:
    """Fresh state on ``device`` (the CUDA device unless named): weights
    and then the sketch tree drawn from a generator seeded with ``seed``,
    unless given (the tests pass the reference's), AdamW moments, the
    compression's error feedback, and a monitor ring with one row per
    node-stack entry. The projections are sized for one worker's tokens,
    ``global_batch // dp_workers * seq_len``; with a dp axis the count
    sketch's {u, v} and the int8 sketch wire's ledger are (W, ...) zeros,
    one row a worker."""
    run = finalize_run(cfg, run)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if params is None:
        params = init_params(gen, cfg)
    else:
        params = tree_map(lambda t: t.to(device), params)
    opt = init_adamw(params, run.optimizer)
    if run.compression is not None:
        opt["err"] = init_error_feedback(params, run.compression)
        if run.dp_axis_name is not None and \
                run.compression.mode == "countsketch":
            opt["err"] = {k: v.expand(run.dp_workers, -1).clone()
                          for k, v in opt["err"].items()}
    if sketch is None:
        sketch = init_lm_sketch_state(
            gen, cfg, run.sketch,
            run.global_batch // run.dp_workers * run.seq_len)
    elif run.sketch.enabled:
        sketch = tree_to(sketch, device)
    else:
        sketch = None
    if sketch is not None and run.sketch_wire_dtype == "int8":
        opt["sketch_err"] = tree_map(
            lambda t: torch.zeros((run.dp_workers,) + tuple(t.shape),
                                  dtype=t.dtype, device=t.device),
            tree_increment_leaves(sketch))
    n_rows = (len(node_paths(sketch)) if sketch is not None
              else max(1, len(sketch_groups(cfg))) * cfg.num_layers)
    return TrainState(params=params, opt=opt, sketch=sketch,
                      adaptive=init_adaptive_state(),
                      monitor=init_monitor_state(run.monitor_window, n_rows,
                                                 device))
