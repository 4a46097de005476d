"""Fault-tolerant LM training loop on one device (counterpart of
``repro.train.loop``):

  * checkpoint/restart — async saves every ``ckpt_every`` steps, resume
    from the latest on start (the data pipeline is stateless, so the
    token stream continues exactly);
  * straggler watchdog — an EMA of the step's wall time; steps slower
    than ``straggler_factor`` times it are counted, and a budget of
    consecutive stragglers saves a checkpoint and exits with code 75
    (temporary failure: a scheduler may retry);
  * NaN guard — the step itself skips non-finite updates; ``max_skips``
    consecutive skips rewind to the last checkpoint;
  * adaptive rank — the controller (paper Algorithm 1) runs each
    pseudo-epoch, refreshing the projections on a rank change.

The data-parallel loop of the reference (``dp_mesh``, per-worker
residual checkpoints) is ROADMAP A11, its sharded one A14, and its
telemetry export waits for a caller.
"""
from __future__ import annotations

import dataclasses
import logging
import sys
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.adaptive import adaptive_step
from repro_torch.data.pipeline import PipelineConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.sketches import refresh_tree
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "artifacts/ckpt"
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    straggler_budget: int = 10
    max_skips: int = 5
    log_every: int = 10
    steps_per_epoch: int = 0          # 0 disables the adaptive controller


def run_training(cfg, run: RunConfig, loop: LoopConfig, *, seed: int = 0,
                 device=None):
    """The training loop on ``device`` (the CUDA device unless
    named). Returns (state, history)."""
    device = resolve_device(device)
    pipe = PipelineConfig(seed=seed, global_batch=run.global_batch,
                          seq_len=run.seq_len, vocab=cfg.vocab_size)
    ckpt = Checkpointer(loop.ckpt_dir, keep=loop.ckpt_keep)
    state = init_train_state(seed, cfg, run, device=device)
    train_step = make_train_step(cfg, run)

    if ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        log.info("restored checkpoint at step %s", meta["step"])
    history = []
    ema_t = None
    stragglers = 0
    consec_skips = 0
    last_skip_total = state.skipped

    for step in range(state.step, loop.num_steps):
        tokens, labels = host_batch(pipe, step, device=device)
        t0 = time.perf_counter()
        state, metrics = train_step(state, {"tokens": tokens,
                                            "labels": labels})
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0

        # straggler watchdog
        if ema_t is None:
            ema_t = dt
        if dt > loop.straggler_factor * ema_t:
            stragglers += 1
            log.warning("straggler step %d: %.3fs vs EMA %.3fs",
                        step, dt, ema_t)
            if stragglers >= loop.straggler_budget:
                log.error("straggler budget exhausted; checkpoint+abort")
                ckpt.save(step + 1, state)
                sys.exit(75)
        else:
            stragglers = 0
        ema_t = 0.9 * ema_t + 0.1 * dt

        # NaN-guard rewind
        new_skip_total = int(metrics["skipped_total"])
        consec_skips = consec_skips + 1 \
            if new_skip_total > last_skip_total else 0
        last_skip_total = new_skip_total
        if consec_skips >= loop.max_skips and ckpt.latest_step() is not None:
            log.error("%d consecutive skipped steps; rewinding", consec_skips)
            state, _ = ckpt.restore(state)
            consec_skips = 0
            continue

        # adaptive rank controller (per pseudo-epoch)
        if (loop.steps_per_epoch and run.adaptive is not None
                and state.sketch is not None
                and (step + 1) % loop.steps_per_epoch == 0):
            adaptive, new_rank, changed = adaptive_step(
                state.adaptive, int(state.sketch.rank), metrics["loss"],
                run.adaptive)
            sketch = dataclasses.replace(state.sketch, rank=torch.tensor(
                new_rank, dtype=torch.int32, device=device))
            if changed:
                # paper Alg. 1 "reinitialize matrices": zero sketches,
                # fresh projections, no shape change
                sketch = refresh_tree(sketch)
                log.info("rank change -> %d at step %d (projection "
                         "refresh, epoch %d)", new_rank, step, sketch.epoch)
            state = dataclasses.replace(state, adaptive=adaptive,
                                        sketch=sketch)

        history.append({"step": step, "time_s": dt, **metrics})
        if step % loop.log_every == 0:
            log.info("step %d loss %.4f grad_norm %.3f (%.3fs)",
                     step, metrics["loss"], metrics["grad_norm"], dt)
        if (step + 1) % loop.ckpt_every == 0:
            ckpt.save_async(step + 1, state)

    ckpt.wait()
    ckpt.save(loop.num_steps, state)
    return state, history
