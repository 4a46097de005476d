"""Adaptive rank controller, paper §4.3, Algorithm 1 (counterpart of
``repro.core.adaptive``).

Patience-driven: sustained improvement shrinks r (saves memory),
stagnation grows it (fidelity), and growth past tau_reset resets it to
r0. Each rank change "reinitializes matrices": the trainer zeroes the
sketches and refreshes the projections (``sketches.tree.refresh_tree``);
shapes never change. The controller runs once an epoch on the host, so
its state is plain Python numbers.
"""
from __future__ import annotations

import dataclasses
import math
import struct


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    r0: int = 2
    r_min: int = 1
    r_max: int = 16
    patience_decrease: int = 3       # epochs of improvement -> shrink
    patience_increase: int = 5       # epochs of stagnation  -> grow
    dr_down: int = 1
    dr_up: int = 2
    tau_reset: int = 14              # r + dr_up >= tau -> reset to r0
    min_delta: float = 1e-4          # relative improvement threshold


@dataclasses.dataclass(frozen=True)
class AdaptiveState:
    best_metric: float = math.inf    # best (lowest) metric seen
    streak_improve: int = 0          # consecutive improving epochs
    streak_stall: int = 0            # consecutive stalled epochs
    num_changes: int = 0             # rank changes so far (diagnostics)


def init_adaptive_state() -> AdaptiveState:
    return AdaptiveState()


def adaptive_step(state: AdaptiveState, rank: int, metric: float,
                  cfg: AdaptiveConfig) -> tuple[AdaptiveState, int, bool]:
    """One per-epoch update -> (new_state, new_rank, changed). The
    metric is compared in f32, as the reference holds it."""
    metric = _f32(metric)
    improved = metric < _f32(state.best_metric * _f32(1.0 - cfg.min_delta))
    streak_improve = state.streak_improve + 1 if improved else 0
    streak_stall = 0 if improved else state.streak_stall + 1
    do_down = streak_improve >= cfg.patience_decrease
    do_up = streak_stall >= cfg.patience_increase
    if do_down:
        new_rank = max(cfg.r_min, rank - cfg.dr_down)
    elif do_up:
        grown = rank + cfg.dr_up
        new_rank = cfg.r0 if grown >= cfg.tau_reset else min(grown, cfg.r_max)
    else:
        new_rank = rank
    changed = new_rank != rank
    reset = do_down or do_up
    return AdaptiveState(
        best_metric=min(state.best_metric, metric),
        streak_improve=0 if reset else streak_improve,
        streak_stall=0 if reset else streak_stall,
        num_changes=state.num_changes + int(changed),
    ), int(new_rank), changed


def _f32(x: float) -> float:
    """``x`` rounded to float32."""
    return struct.unpack("f", struct.pack("f", x))[0]
