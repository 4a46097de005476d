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

With ``run.dp_axis_name`` set the step is the W-worker data-parallel
step (``train.step``) on the global batch. Its per-worker ledgers (the
count sketch's {u, v}, the int8 sketch wire's ``sketch_err``) are
stacked (W, ...) in the state already, and checkpoints keep them so,
with ``residual_layout="per_worker_v1"`` and ``dp_workers`` in their
metadata: a restart at another worker count gives every new worker
total / W_new of each ledger, the reference's elastic rule. The
sharded loop of the reference is ROADMAP A14, and its telemetry export
waits for a caller.
"""
from __future__ import annotations

import dataclasses
import logging
import sys
import time

import torch

from repro_torch.checkpoint.checkpointer import RESIDUAL_LAYOUT, Checkpointer
from repro_torch.core.adaptive import adaptive_step
from repro_torch.data.pipeline import PipelineConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.optim.flat import tree_map
from repro_torch.sketches import refresh_tree
from repro_torch.train.state import RunConfig, init_train_state
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.train")

PER_WORKER = ("err", "sketch_err")


def _per_worker_keys(state, run: RunConfig) -> list[str]:
    """The state's per-worker ledgers: the count sketch's error feedback
    and the int8 sketch wire's, under a dp axis."""
    if run.dp_axis_name is None:
        return []
    cs = run.compression is not None and run.compression.mode == "countsketch"
    return [k for k in PER_WORKER if k in state.opt and (k != "err" or cs)]


def _metadata(state, run: RunConfig) -> dict:
    if not _per_worker_keys(state, run):
        return {}
    return {"residual_layout": RESIDUAL_LAYOUT, "dp_workers": run.dp_workers}


def save_state(ckpt: Checkpointer, step: int, state, run: RunConfig, *,
               block: bool = True) -> None:
    """Save ``state`` at ``step``, with the per-worker layout's metadata
    when it holds per-worker ledgers (written on a thread unless
    ``block``)."""
    save = ckpt.save if block else ckpt.save_async
    save(step, state, metadata=_metadata(state, run))


def restore_state(ckpt: Checkpointer, template, run: RunConfig):
    """(state, metadata) of the latest checkpoint in ``template``'s
    structure and devices. Per-worker ledgers saved at W_old workers are
    split for ``run.dp_workers`` = W_new: each worker gets the sum of the
    W_old rows over W_new, so the total residual mass is kept."""
    state, meta = ckpt.restore(template)
    layout = meta.get("residual_layout")
    if layout is None:
        return state, meta
    if layout != RESIDUAL_LAYOUT:
        raise ValueError(f"unknown residual_layout {layout!r}")
    w_old, w_new = int(meta["dp_workers"]), run.dp_workers
    if w_old != w_new:
        opt = dict(state.opt)
        for k in _per_worker_keys(state, run):
            opt[k] = tree_map(lambda t: (t.sum(0) / w_new).expand(
                (w_new,) + tuple(t.shape[1:])).clone(), opt[k])
        state = dataclasses.replace(state, opt=opt)
        log.info("elastic residual split %d -> %d workers", w_old, w_new)
    return state, meta


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

    if run.dp_axis_name is not None:
        log.info("data-parallel step: %d workers on %r", run.dp_workers,
                 run.dp_axis_name)
    if ckpt.latest_step() is not None:
        state, meta = restore_state(ckpt, state, run)
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
                save_state(ckpt, step + 1, state, run)
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
            state, _ = restore_state(ckpt, state, run)
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
            save_state(ckpt, step + 1, state, run, block=False)

    ckpt.wait()
    save_state(ckpt, loop.num_steps, state, run)
    return state, history
