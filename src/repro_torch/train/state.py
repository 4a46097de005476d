"""Train state and run configuration of the LM trainer (counterpart of
``repro.train.state``), single device.

``RunConfig`` keeps the reference's fields. The data-parallel, ring,
merge and sketch-wire fields exist so that a config reads the same in
both packages, and any value but the single-device default raises,
naming the ROADMAP item that ports it (A11 data parallelism, A14 mesh
sharding).
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
    # the reference's data-parallel and mesh fields; only the
    # single-device values are ported
    dp_axis_name: str | tuple[str, ...] | None = None
    dp_workers: int = 1
    dp_collective: str = "fused"
    dp_merge: str = "psum"
    sketch_wire_dtype: str = "fp32"
    ring_wire: bool = False
    p2_overlap: bool = True

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
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
        not_ported = {
            "dp_axis_name": (self.dp_axis_name is not None, "A11"),
            "dp_workers": (self.dp_workers != 1, "A11"),
            "dp_collective": (self.dp_collective != "fused", "A11"),
            "sketch_wire_dtype": (self.sketch_wire_dtype != "fp32", "A11"),
            "ring_wire": (self.ring_wire, "A11 (with the ring kernel, B7)"),
            "dp_merge": (self.dp_merge != "psum", "A14"),
        }
        for name, (set_, item) in not_ported.items():
            if set_:
                raise NotImplementedError(
                    f"RunConfig.{name}={getattr(self, name)!r}: "
                    f"data-parallel and sharded training are not ported "
                    f"yet: ROADMAP {item}")


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
    node-stack entry."""
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
    if sketch is None:
        sketch = init_lm_sketch_state(gen, cfg, run.sketch,
                                      run.global_batch * run.seq_len)
    elif run.sketch.enabled:
        sketch = tree_to(sketch, device)
    else:
        sketch = None
    n_rows = (len(node_paths(sketch)) if sketch is not None
              else max(1, len(sketch_groups(cfg))) * cfg.num_layers)
    return TrainState(params=params, opt=opt, sketch=sketch,
                      adaptive=init_adaptive_state(),
                      monitor=init_monitor_state(run.monitor_window, n_rows,
                                                 device))
