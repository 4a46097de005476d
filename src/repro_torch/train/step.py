"""The LM training step (counterpart of ``repro.train.step``), single
program: forward with sketched backprop, the backward, gradient
compression, AdamW with warmup-cosine, the NaN guard and the per-step
monitor record.

The reference's data-parallel layouts (fused, per-node and overlapped
collectives, the reduce-scatter merge, the p2 overlap) are ROADMAP A11
and A14; ``RunConfig`` refuses them.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.monitor import monitor_record, tree_metrics
from repro_torch.models.transformer import forward, reference_leaves
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compression import compress_grads
from repro_torch.optim.flat import FlatLayout, get_path, leaf_paths, tree_like
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.sketched_sgd import compress_grads_countsketch
from repro_torch.train.state import RunConfig, TrainState, finalize_run

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor,
                  z_weight: float = 0.0) -> Tensor:
    """Mean next-token cross-entropy in f32, plus ``z_weight`` times the
    mean squared log-partition (the z-loss)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    true = lg.gather(-1, labels[..., None])[..., 0]
    ce = (lse - true).mean()
    if z_weight > 0:
        ce = ce + z_weight * (lse ** 2).mean()
    return ce


def make_loss_and_grads(cfg: ArchConfig, run: RunConfig) -> Callable:
    """``fn(state, batch) -> (loss, ce, aux, grads, new_sketch)``: the
    forward in train mode (updating the sketch tree), the loss and its
    gradients with respect to the parameters, all detached."""

    def loss_and_grads(state: TrainState, batch: dict):
        paths = leaf_paths(state.params)
        leaves = [get_path(state.params, p).detach().requires_grad_(True)
                  for p in paths]
        live = tree_like(state.params, leaves)
        out = forward(live, batch["tokens"], cfg=cfg, mode="train",
                      sketch_state=state.sketch, settings=run.sketch)
        ce = cross_entropy(out["logits"], batch["labels"], run.z_weight)
        loss = ce + run.aux_weight * out["aux"]
        grads = tree_like(state.params, torch.autograd.grad(loss, leaves))
        return (loss.detach(), ce.detach(), out["aux"].detach(), grads,
                out["sketch_state"])

    return loss_and_grads


def make_train_step(cfg: ArchConfig, run: RunConfig, *,
                    cs_params=None) -> Callable:
    """``step(state, batch) -> (new_state, metrics)`` for batches
    {"tokens", "labels"} of (B, S) int64 on the state's device.

    Compression sees the gradient as the reference does: count-sketch
    the flat vector in its ``ravel_pytree`` order, top-k each of its
    stacked leaves (``models.transformer.reference_leaves``).
    ``cs_params`` replaces the hash coefficients drawn from ``cs_seed``
    (the reference's, in the tests). A step whose loss or gradient norm
    is not finite keeps the old parameters, optimizer state (error
    feedback included) and sketch tree, and counts a skip.
    ``step.loss_and_grads`` and ``step.apply_grads`` are its two halves.
    """
    run = finalize_run(cfg, run)
    comp = run.compression
    flat: dict = {}
    loss_and_grads = make_loss_and_grads(cfg, run)

    def layout(params):
        """The reference's flat order, and its leaves' sizes, built once."""
        if not flat:
            leaves = reference_leaves(params, cfg)
            flat["layout"] = FlatLayout(params, [p for lf in leaves
                                                 for p in lf])
            flat["sizes"] = [sum(get_path(params, p).numel() for p in lf)
                             for lf in leaves]
        return flat["layout"], flat["sizes"]

    def apply_grads(state: TrainState, loss, ce, aux, grads, new_sketch):
        new_err = None
        if comp is not None and comp.mode == "countsketch":
            grads, new_err, _ = compress_grads_countsketch(
                grads, state.opt["err"], comp, layout=layout(state.params)[0],
                params=cs_params)
        elif comp is not None:
            lay, sizes = layout(state.params)
            grads, new_err, _ = compress_grads(grads, state.opt["err"], comp,
                                               layout=lay, sizes=sizes)
        lr_scale = warmup_cosine(state.step, warmup_steps=run.warmup_steps,
                                 total_steps=run.total_steps)
        opt_in = {k: v for k, v in state.opt.items() if k != "err"}
        new_params, new_opt, om = adamw_update(
            state.params, grads, opt_in, run.optimizer, lr_scale)
        del grads
        if new_err is not None:
            new_opt["err"] = new_err
        good = bool(torch.isfinite(loss) & torch.isfinite(om["grad_norm"]))
        if run.nan_guard and not good:
            new_params, new_opt, new_sketch = (state.params, state.opt,
                                               state.sketch)
        monitor = state.monitor
        if new_sketch is not None:
            monitor = monitor_record(monitor, tree_metrics(new_sketch))
        new_state = TrainState(
            params=new_params, opt=new_opt, sketch=new_sketch,
            adaptive=state.adaptive, monitor=monitor, step=state.step + 1,
            skipped=state.skipped + (not good))
        metrics = {"loss": loss, "ce": ce, "aux": aux,
                   "grad_norm": om["grad_norm"], "lr_scale": lr_scale,
                   "skipped_total": new_state.skipped}
        return new_state, metrics

    def train_step(state: TrainState, batch: dict):
        return apply_grads(state, *loss_and_grads(state, batch))

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_grads = apply_grads
    return train_step
