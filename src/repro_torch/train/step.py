"""The LM training step (counterpart of ``repro.train.step``): forward
with sketched backprop, the backward, gradient compression, AdamW with
warmup-cosine, the NaN guard and the per-step monitor record.

With ``RunConfig.dp_axis_name`` set the step is the reference's
single-axis data-parallel step (``make_dp_train_step``), its W workers
run in turn in this process (``repro_torch.parallel``): each takes rows
[w B/W, (w+1) B/W) of the batch, and the collectives merge what the
reference's shard_map merges across devices, in the layout
``RunConfig.dp_collective`` names:

  * "fused": each worker's forward emits its local sketch increments and
    consumes the tree merged through the previous step; ONE flat-segment
    collective carries the increments, the gradient wire (the count
    sketch's table or the dense gradients), the scalar metrics and a
    worker counter;
  * "overlap": a sweep of the forwards emits the increments, the early
    collective merges them and the tree takes them in before the
    forward-backward consumes it; the late collective carries the rest.
    A tree with no consumer (monitoring only) takes the fused layout;
  * "per_node": the reference psums each node leaf inside the forward,
    which gives the overlap schedule's values; here it runs as those
    phases, with one collective a node leaf and layer, three scalar
    means and the gradient wire (one mean a parameter leaf, or the
    table and its p2 round).

``ring_wire`` sends the flat buffer through the ring kernel
(``kernels.ring_allreduce``) instead of the psum; with the int8 sketch
wire the sketch increments ride the quantising ring and its residuals
become each worker's ``sketch_err``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.monitor import monitor_record, tree_metrics
from repro_torch.models import transformer
from repro_torch.optim.adamw import adamw_sparse_update, adamw_update
from repro_torch.optim.compression import compress_grads, compressed_bytes
from repro_torch.optim.flat import FlatLayout, get_path, leaf_paths, tree_like
from repro_torch.optim.flat import tree_map
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.sketched_sgd import (
    compress_grads_countsketch, countsketch_complete_dp,
    countsketch_finish_dp, countsketch_local, countsketch_nominate_dp,
)
from repro_torch.parallel.collectives import (
    _record, fold, psum_csvec, psum_flat_segments, traced_psum,
)
from repro_torch.sketches.registry import node_specs_for
from repro_torch.sketches.wire import (
    fake_quantize_tree, partition_segments, tree_increment_leaves,
)
from repro_torch.train.state import RunConfig, TrainState, finalize_run

Tensor = torch.Tensor

# Segments that stay exact f32 when the int8 ring carries the sketch
# increments: worker counters and loss scalars, the count-sketch table
# (its int8 wire has its own grid and error feedback) and dense
# gradients (no ledger of their own). They ride one small f32 psum.
_RING_EXEMPT = ("n", "scalars", "cs_table", "grads")


CE_ROWS = 1024       # logit rows a chunk of the loss widens to f32


class _CrossEntropy(torch.autograd.Function):
    """``cross_entropy`` with the logits widened to f32 ``CE_ROWS`` rows
    at a time, forward and backward, and only the logits in their own
    type kept for the backward. Autograd through the whole-tensor form
    keeps the (N, V) f32 logits and makes two more in the backward, 4.2
    GB each at recurrentgemma-2b's 256,000-word vocabulary and 4,096
    tokens. Each row's arithmetic is that form's gradient's: d lse = g /
    N (+ (g z / N) 2 lse), d logits = d lse exp(logits - lse) and -g / N
    added at the label."""

    @staticmethod
    def forward(ctx, logits, labels, z_weight):
        V = logits.shape[-1]
        flat, lab = logits.reshape(-1, V), labels.reshape(-1, 1)
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=logits.device)
        true = torch.empty_like(lse)
        for r0 in range(0, flat.shape[0], CE_ROWS):
            lg = flat[r0:r0 + CE_ROWS].float()
            lse[r0:r0 + CE_ROWS] = torch.logsumexp(lg, dim=-1)
            true[r0:r0 + CE_ROWS] = lg.gather(-1, lab[r0:r0 + CE_ROWS])[:, 0]
        lse, true = lse.view(labels.shape), true.view(labels.shape)
        ce = (lse - true).mean()
        if z_weight > 0:
            ce = ce + z_weight * (lse ** 2).mean()
        ctx.save_for_backward(logits, labels, lse)
        ctx.z_weight = z_weight
        return ce

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        V, N = logits.shape[-1], lse.numel()
        gn = g / N
        d_lse = gn.expand(N)
        if ctx.z_weight > 0:
            d_lse = d_lse + (g * ctx.z_weight) / N * (2 * lse.reshape(-1))
        lse, lab = lse.reshape(-1, 1), labels.reshape(-1, 1)
        flat = logits.reshape(-1, V)
        grad = torch.empty_like(flat)
        for r0 in range(0, N, CE_ROWS):
            rows = slice(r0, r0 + CE_ROWS)
            d = d_lse[rows, None] * torch.exp(flat[rows].float() - lse[rows])
            d.scatter_add_(-1, lab[rows], (-gn).expand(d.shape[0], 1))
            grad[rows] = d
        return grad.view(logits.shape), None, None


def cross_entropy(logits: Tensor, labels: Tensor,
                  z_weight: float = 0.0) -> Tensor:
    """Mean next-token cross-entropy in f32, plus ``z_weight`` times the
    mean squared log-partition (the z-loss)."""
    return _CrossEntropy.apply(logits, labels, z_weight)


def make_loss_and_grads(cfg: ArchConfig, run: RunConfig) -> Callable:
    """``fn(state, batch, settings=run.sketch) -> (loss, ce, aux, grads,
    new_sketch)``: the forward in train mode (updating the sketch tree,
    or emitting its increments under ``dp_defer``), the loss and its
    gradients with respect to the parameters, all detached."""

    def loss_and_grads(state: TrainState, batch: dict, settings=None):
        paths = leaf_paths(state.params)
        leaves = [get_path(state.params, p).detach().requires_grad_(True)
                  for p in paths]
        live = tree_like(state.params, leaves)
        out = transformer.forward(live, batch["tokens"], cfg=cfg,
                                  mode="train", sketch_state=state.sketch,
                                  settings=settings or run.sketch,
                                  patch_embeds=batch.get("patch_embeds"))
        ce = cross_entropy(out["logits"], batch["labels"], run.z_weight)
        loss = ce + run.aux_weight * out["aux"]
        grads = tree_like(state.params, torch.autograd.grad(loss, leaves))
        return (loss.detach(), ce.detach(), out["aux"].detach(), grads,
                out["sketch_state"])

    return loss_and_grads


def _apply_merged_increments(old_tree, inc_tree, merged_leaves, beta):
    """Fold the merged per-node increments into the previous step's tree:
    ``mask(beta * old + inc)`` per x/y/z leaf, the accumulate of the
    per-node layout, in ``inc_tree``'s structure (its step advanced)."""
    from repro_torch.sketches.update import ema_apply_increment

    k_active = inc_tree.k_active
    nodes = {}
    for name, node in old_tree.nodes.items():
        m = merged_leaves[name]
        nodes[name] = dataclasses.replace(
            inc_tree.nodes[name],
            x=ema_apply_increment(node.x, m["x"], beta, k_active),
            y=ema_apply_increment(node.y, m["y"], beta, k_active),
            z=ema_apply_increment(node.z, m["z"], beta, k_active))
    return dataclasses.replace(inc_tree, nodes=nodes)


class _WireOut(NamedTuple):
    """What the flat-segment exchange hands back."""
    loss: Any
    ce: Any
    aux: Any
    grads: Any        # None while a p2 round is pending (then in ``p2``)
    err: Any          # the new compression error feedback, or None
    sketch: Any       # merged sketch increments (fused layout), or None
    sketch_err: Any   # the new int8 sketch-wire ledgers (W, ...), or None
    p2: Any           # (locals, merged table, workers) for the p2 round


def _worker_rows(tree, w: int):
    """Worker w's row of every (W, ...) leaf."""
    return tree_map(lambda t: t[w], tree)


def _add_trees(a, b):
    """``a + b`` leaf by leaf over two trees of one structure."""
    return tree_like(a, [get_path(a, p) + get_path(b, p)
                         for p in leaf_paths(a)])


def _stack_rows(trees: list):
    return tree_like(trees[0], [torch.stack(ts) for ts in zip(
        *[[get_path(t, p) for p in leaf_paths(t)] for t in trees])])


def _merge_wire(run: RunConfig, state, segs, *, name: str, int8: bool,
                barrier: bool = False):
    """Merge the workers' segment dicts ``segs`` (a generator, worker 0's
    first) in one collective, routed as the run says: the psum, the fp32
    ring, or with ``int8`` the int8 sketch wire. That wire carries each
    worker's "sketch" segment plus its residual from last step's
    quantisation (the mass catch-up), quantised by the ring (the other
    segments ride its exempt f32 psum) or here when the wire is
    simulated; its residuals become the new ledgers. Returns (merged, the
    new (W, ...) ledgers or None)."""
    residuals = []

    def adjusted():
        for w, seg in enumerate(segs):
            if int8:
                adj = _add_trees(seg["sketch"], _worker_rows(
                    state.opt["sketch_err"], w))
                if run.ring_wire:
                    seg["sketch"] = adj
                else:
                    seg["sketch"], res = fake_quantize_tree(adj)
                    residuals.append(res)
            yield seg
            del seg

    if not run.ring_wire:
        merged = psum_flat_segments(adjusted(), name=name, barrier=barrier)
        return merged, (_stack_rows(residuals) if int8 else None)
    if not int8:
        return psum_flat_segments(adjusted(), name=name, barrier=barrier,
                                  ring="fp32",
                                  ring_workers=run.dp_workers), None
    merged, ring_res = psum_flat_segments(
        adjusted(), name=name, barrier=barrier, ring="int8",
        ring_workers=run.dp_workers, ring_exempt=_RING_EXEMPT)
    return merged, ring_res["sketch"]


def _psum_wire_segments(run: RunConfig, layout, state, outs, *,
                        with_sketch: bool, p2_defer: bool, name: str,
                        cs_params=None) -> _WireOut:
    """THE flat-segment exchange of the fused and overlap layouts. For
    each worker's ``{"loss", "ce", "aux", "grads"[, "sketch"]}`` of
    ``outs`` (a generator, so a worker's gradients are dropped once
    packed) it packs the gradient wire (the count sketch's table, int8
    grid values under its int8 wire, or the dense gradients in the
    reference's flat order), the scalars, a constant-1 worker counter
    and, in the fused layout, the sketch increments, merges them in one
    collective (``_merge_wire``) and finishes the merge. With
    ``p2_defer`` the p2 round is left to the caller. ``layout`` is
    ``_reference_layout``'s pair."""
    layout, sizes = layout
    comp = run.compression
    cs_mode = comp is not None and comp.mode == "countsketch"
    err = state.opt.get("err")
    new_err = None
    if cs_mode:
        new_err = {k: torch.empty_like(v) for k, v in err.items()}
    locals_ = []

    def segments():
        for w, out in enumerate(outs):
            seg = {"n": torch.ones((), dtype=torch.float32,
                                   device=out["loss"].device),
                   "scalars": torch.stack([out["loss"], out["ce"],
                                           out["aux"]])}
            if with_sketch:
                seg["sketch"] = out["sketch"]
            if cs_mode:
                local = countsketch_local(
                    out["grads"], _worker_rows(err, w), comp, layout,
                    cs_params, out=_worker_rows(new_err, w))
                locals_.append(local)
                seg["cs_table"] = local.cs.table
            else:
                seg["grads"] = layout.leaves(out["grads"])
            if not with_sketch:
                early, seg = partition_segments(seg)
                if early:
                    raise ValueError(
                        f"early-keyed segments {sorted(early)} on the late "
                        f"wire psum — they must ride the early collective")
            del out
            yield seg
            del seg

    merged, new_sketch_err = _merge_wire(
        run, state, segments(), name=name,
        int8=with_sketch and run.sketch_wire_dtype == "int8")
    workers = merged["n"]
    loss, ce, aux = (merged["scalars"][i] / workers for i in range(3))
    p2 = None
    if cs_mode:
        merged_cs = dataclasses.replace(locals_[0].cs,
                                        table=merged["cs_table"])
        if p2_defer and comp.cs_p2 > 0:
            grads = None
            p2 = (locals_, merged_cs, workers)
        else:
            grads, _, _ = countsketch_finish_dp(locals_, merged_cs,
                                                workers=workers)
    else:
        grads = layout.tree_of([g / workers for g in merged["grads"]])
        if comp is not None:
            grads, new_err, _ = compress_grads(grads, err, comp,
                                               layout=layout, sizes=sizes)
    return _WireOut(loss, ce, aux, grads, new_err, merged.get("sketch"),
                    new_sketch_err, p2)


def _reference_layout(cfg: ArchConfig, params) -> tuple[FlatLayout, list]:
    """The reference's flat order of ``params`` (``ravel_pytree`` of its
    stacked tree), and the elements of each of its stacked leaves in
    that order (the top-k compression takes its k per leaf; the
    per-node layout means one leaf at a time)."""
    leaves = transformer.reference_leaves(params, cfg)
    return (FlatLayout(params, [p for lf in leaves for p in lf]),
            [sum(get_path(params, p).numel() for p in lf) for lf in leaves])


def make_train_step(cfg: ArchConfig, run: RunConfig, *,
                    cs_params=None) -> Callable:
    """``step(state, batch) -> (new_state, metrics)`` for batches
    {"tokens", "labels"} of (B, S) int64 on the state's device, and for a
    "vision" frontend optionally "patch_embeds" (B, f, d), which every
    train-mode forward splices in (the data-parallel step splits its rows
    with the tokens'). The eval step takes none, as the reference's.

    Compression sees the gradient as the reference does: count-sketch
    the flat vector in its ``ravel_pytree`` order, top-k each of its
    stacked leaves (``models.transformer.reference_leaves``).
    ``cs_params`` replaces the hash coefficients drawn from ``cs_seed``
    (the reference's, in the tests). A step whose loss or gradient norm
    is not finite keeps the old parameters, optimizer state (error
    feedback included) and sketch tree, and counts a skip. With
    ``run.dp_axis_name`` set it is the W-worker step of the module
    docstring. ``step.loss_and_grads`` and ``step.apply_grads`` are the
    single-worker step's two halves.
    """
    run = finalize_run(cfg, run)
    if run.dp_axis_name is not None:
        return _make_dp_step(cfg, run, cs_params)
    comp = run.compression
    flat: dict = {}
    loss_and_grads = make_loss_and_grads(cfg, run)

    def layout(params):
        if not flat:
            flat["layout"] = _reference_layout(cfg, params)
        return flat["layout"]

    def apply_grads(state: TrainState, loss, ce, aux, grads, new_sketch):
        new_err = None
        if comp is not None and comp.mode == "countsketch":
            grads, new_err, _ = compress_grads_countsketch(
                grads, state.opt["err"], comp,
                layout=layout(state.params)[0], params=cs_params)
        elif comp is not None:
            lay, sizes = layout(state.params)
            grads, new_err, _ = compress_grads(
                grads, state.opt["err"], comp, layout=lay, sizes=sizes)
        lr_scale = warmup_cosine(state.step, warmup_steps=run.warmup_steps,
                                 total_steps=run.total_steps)
        opt_in = {k: v for k, v in state.opt.items() if k != "err"}
        new_params, new_opt, om = adamw_update(
            state.params, grads, opt_in, run.optimizer, lr_scale)
        del grads
        return _finish(run, state, loss, ce, aux, new_params, new_opt, om,
                       lr_scale, new_sketch, new_err, None)

    def train_step(state: TrainState, batch: dict):
        return apply_grads(state, *loss_and_grads(state, batch))

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_grads = apply_grads
    return train_step


def _finish(run, state, loss, ce, aux, new_params, new_opt, om, lr_scale,
            new_sketch, new_err, new_sketch_err):
    """The NaN guard, the monitor record and the new state."""
    if new_err is not None:
        new_opt["err"] = new_err
    if new_sketch_err is not None:
        new_opt["sketch_err"] = new_sketch_err
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


def _split_batch(batch: dict, workers: int) -> list[dict]:
    """Worker w's rows [w B/W, (w+1) B/W) of every batch entry."""
    b = batch["tokens"].shape[0] // workers
    return [{k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            for w in range(workers)]


MOE_DP = ("data-parallel training of MoE archs is not ported yet: ROADMAP "
          "A17, MoE data-parallel training (the expert_in stacks' "
          "increments on the wire)")


def _make_dp_step(cfg: ArchConfig, run: RunConfig, cs_params) -> Callable:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: {MOE_DP}")
    W, comp = run.dp_workers, run.compression
    groups = transformer.sketch_groups(cfg) if run.sketch.enabled else {}
    consumed = bool(groups) and "res" not in groups
    overlap = run.dp_collective == "overlap" and consumed
    fused = not overlap and run.dp_collective in ("fused", "overlap")
    per_node = not (overlap or fused)
    run.validate(consumed=consumed)
    cs_mode = comp is not None and comp.mode == "countsketch"
    # the forwards of the phases: per_node's psums inside the forward
    # (``dp_axis``) run as the increment sweep, the merge and the
    # pre-merged forward
    plain_st = dataclasses.replace(run.sketch, dp_axis=None)
    defer_st = dataclasses.replace(plain_st, dp_defer=True)
    premerged_st = dataclasses.replace(plain_st, dp_premerged=True)
    p2o = run.p2_overlap and cs_mode and comp.cs_p2 > 0 and not per_node
    loss_and_grads = make_loss_and_grads(cfg, run)
    flat: dict = {}

    def increments(state, batch):
        """One worker's sweep emitting its local increments (no grad)."""
        with torch.no_grad():
            out = transformer.forward(
                state.params, batch["tokens"], cfg=cfg, mode="train",
                sketch_state=state.sketch, settings=defer_st,
                patch_embeds=batch.get("patch_embeds"))
        return out["sketch_state"]

    def train_step(state: TrainState, batch: dict):
        if batch["tokens"].shape[0] != run.global_batch:
            raise ValueError(
                f"batch of {batch['tokens'].shape[0]} rows, the run's "
                f"global_batch is {run.global_batch}")
        if not flat:
            flat["layout"] = _reference_layout(cfg, state.params)
        layout = flat["layout"]       # (FlatLayout, leaf sizes)
        shards = _split_batch(batch, W)
        new_err = new_sketch_err = p2 = None
        if fused:
            def outs():
                for b in shards:
                    loss, ce, aux, grads, inc = loss_and_grads(
                        state, b, defer_st if groups else plain_st)
                    out = {"loss": loss, "ce": ce, "aux": aux,
                           "grads": grads}
                    del grads
                    if groups:
                        holder.setdefault("tree", inc)
                        out["sketch"] = tree_increment_leaves(inc)
                    yield out
                    del out

            holder: dict = {}
            w = _psum_wire_segments(run, layout, state, outs(),
                                    with_sketch=bool(groups), p2_defer=p2o,
                                    name="fused_step", cs_params=cs_params)
            loss, ce, aux, grads, new_err, p2 = (w.loss, w.ce, w.aux,
                                                 w.grads, w.err, w.p2)
            new_sketch_err = w.sketch_err
            new_sketch = (_apply_merged_increments(
                state.sketch, holder["tree"], w.sketch, run.sketch.beta)
                if groups else state.sketch)
        else:
            # phase 1: every worker's increments, merged, taken in
            new_sketch = state.sketch
            if groups:
                trees: list = []

                def early():
                    for w_, b in enumerate(shards):
                        trees.append(increments(state, b))
                        leaves = tree_increment_leaves(trees[-1])
                        if w_:
                            trees[-1] = None
                        yield leaves

                new_sketch, new_sketch_err = _early_merge(
                    run, state, early(), overlap, trees)
            phase2 = dataclasses.replace(state, sketch=new_sketch)
            st2 = premerged_st if groups else plain_st
            if overlap:
                def outs():
                    for b in shards:
                        loss, ce, aux, grads, _ = loss_and_grads(phase2, b,
                                                                 st2)
                        yield {"loss": loss, "ce": ce, "aux": aux,
                               "grads": grads}
                        del grads

                w = _psum_wire_segments(run, layout, state, outs(),
                                        with_sketch=False, p2_defer=p2o,
                                        name="overlap_grad",
                                        cs_params=cs_params)
                loss, ce, aux, grads, new_err, p2 = (w.loss, w.ce, w.aux,
                                                     w.grads, w.err, w.p2)
            else:
                loss, ce, aux, grads, new_err = _per_node_wire(
                    run, layout, state, phase2, shards, st2, loss_and_grads,
                    cs_params)
        lr_scale = warmup_cosine(state.step, warmup_steps=run.warmup_steps,
                                 total_steps=run.total_steps)
        opt_in = {k: v for k, v in state.opt.items()
                  if k not in ("err", "sketch_err")}
        if p2 is not None:
            # the p2 round beside the optimizer: the dense AdamW pass on
            # zero gradients needs nothing of it, then exactly the k
            # winning coordinates are recomputed from the old state
            locals_, merged_cs, wk = p2
            cand, exacts = countsketch_nominate_dp(locals_, merged_cs)
            exact = traced_psum(exacts, name="cs_p2_values")
            update, sel_idx, _, _, _ = countsketch_complete_dp(
                locals_, merged_cs, cand, exact, workers=wk)
            del locals_, p2
            new_params, new_opt, om = adamw_sparse_update(
                state.params, opt_in, run.optimizer, lr_scale,
                update=update, idx=sel_idx, layout=layout[0])
        else:
            new_params, new_opt, om = adamw_update(
                state.params, grads, opt_in, run.optimizer, lr_scale)
        del grads
        return _finish(run, state, loss, ce, aux, new_params, new_opt, om,
                       lr_scale, new_sketch, new_err, new_sketch_err)

    return train_step


def _early_merge(run, state, leaves_iter, overlap, trees: list):
    """Merge the workers' sketch increments before the forward-backward
    consumes them: the overlap layout's early collective (``_merge_wire``
    on the one "sketch" segment), or per_node's collective per node leaf
    and layer. ``trees`` holds worker 0's increment tree once
    ``leaves_iter`` is spent. Returns (the new tree, the new int8 ledgers
    or None)."""
    new_sketch_err = None
    if overlap:
        merged, new_sketch_err = _merge_wire(
            run, state, ({"sketch": lv} for lv in leaves_iter),
            name="overlap_sketch", barrier=True,
            int8=run.sketch_wire_dtype == "int8")
        merged = merged["sketch"]
    else:
        # per_node: the reference psums each (d, k) entry of every node
        # leaf inside the forward; the fold of the stacked leaves is the
        # same sums, recorded one collective an entry
        per_worker = list(leaves_iter)
        merged = {}
        for name in per_worker[0]:
            merged[name] = {}
            for a in ("x", "y", "z"):
                xs = [lv[name][a] for lv in per_worker]
                for _ in range(xs[0].shape[0]):
                    _record(f"node_{name}_{a}", xs[0][0].numel() * 4)
                merged[name][a] = fold(xs)
    return (_apply_merged_increments(state.sketch, trees[0], merged,
                                     run.sketch.beta), new_sketch_err)


def _per_node_wire(run, layout, state, phase2, shards, settings,
                   loss_and_grads, cs_params):
    """per_node's forward-backward and gradient wire: each worker's loss
    and gradients on the merged tree, three scalar means, then the
    table's psum and the serial p2 round (count sketch) or one mean a
    parameter leaf of the reference's (dense)."""
    (layout, sizes), W, comp = layout, run.dp_workers, run.compression
    cs_mode = comp is not None and comp.mode == "countsketch"
    err = state.opt.get("err")
    new_err = ({k: torch.empty_like(v) for k, v in err.items()}
               if cs_mode else None)
    scalars, locals_, acc = [], [], None
    for w, b in enumerate(shards):
        loss, ce, aux, grads, _ = loss_and_grads(phase2, b, settings)
        scalars.append(torch.stack([loss, ce, aux]))
        if cs_mode:
            locals_.append(countsketch_local(
                grads, _worker_rows(err, w), comp, layout, cs_params,
                out=_worker_rows(new_err, w)))
        elif acc is None:
            acc = [g.clone() for g in layout.leaves(grads)]
        else:
            for a, g in zip(acc, layout.leaves(grads)):
                a += g
        del grads
    for name in ("loss", "ce", "aux"):
        _record(f"pmean_{name}", 4)
    sums = fold(scalars)
    loss, ce, aux = (sums[i] / W for i in range(3))
    if cs_mode:
        merged = psum_csvec([lc.cs for lc in locals_])
        grads, states, _ = countsketch_finish_dp(locals_, merged,
                                                 workers=float(W))
        return loss, ce, aux, grads, new_err
    for size in sizes:
        _record("pmean_grads", 4 * size)
    grads = layout.tree_of([a / W for a in acc])
    if comp is not None:
        grads, new_err, _ = compress_grads(grads, err, comp, layout=layout,
                                           sizes=sizes)
    return loss, ce, aux, grads, new_err


def make_dp_train_step(cfg: ArchConfig, run: RunConfig, *,
                       cs_params=None) -> Callable:
    """The W-worker data-parallel step (the reference's shard_map step
    over ``run.dp_axis_name``), W = ``run.dp_workers``: the batch's
    leading axis splits over the workers, the state is held once
    (``RunConfig`` has checked that the global batch splits evenly; the
    step checks each batch's rows). ``cs_params`` as in
    ``make_train_step``."""
    if run.dp_axis_name is None:
        raise ValueError("make_dp_train_step needs run.dp_axis_name naming "
                         "the worker axis")
    return make_train_step(cfg, run, cs_params=cs_params)


def make_eval_step(cfg: ArchConfig, run: RunConfig) -> Callable:
    def eval_step(params, batch):
        out = transformer.forward(params, batch["tokens"], cfg=cfg,
                                  mode="eval")
        return cross_entropy(out["logits"], batch["labels"])
    return eval_step


def collective_plan(cfg: ArchConfig, run: RunConfig,
                    num_params: int | None = None,
                    mesh_shape: dict | None = None) -> dict:
    """Structural per-step DP accounting (the reference's): how many
    collectives one step issues under the run's layout and the bytes one
    worker puts on the wire. Pure bookkeeping from the configs."""
    run = finalize_run(cfg, run)
    ax = run.dp_axis_name
    mesh = dict(mesh_shape) if mesh_shape else {}

    def _plan(layout, wire_bytes, *, ar=0, p2_overlap=False):
        per_axis = {} if ax is None else {ax: ar}
        for a in mesh:
            if a != ax:
                per_axis[a] = 0
        return {"layout": layout, "collectives": ar,
                "wire_bytes": wire_bytes, "mesh": mesh,
                "by_kind": {"all_reduce": ar, "reduce_scatter": 0,
                            "all_gather": 0},
                "per_axis": per_axis, "ring_wire": run.ring_wire,
                "sketch_wire_dtype": run.sketch_wire_dtype,
                "p2_overlap": p2_overlap}

    if ax is None:
        return _plan("single_program", 0)
    groups = transformer.sketch_groups(cfg) if run.sketch.enabled else {}
    consumed = bool(groups) and "res" not in groups
    overlap = run.dp_collective == "overlap" and consumed
    fused = not overlap and run.dp_collective in ("fused", "overlap")
    cs = run.compression is not None and \
        run.compression.mode == "countsketch"
    cs_p2 = 1 if cs and run.compression.cs_p2 > 0 else 0
    p2o = run.p2_overlap and cs_p2 > 0 and \
        run.dp_collective in ("fused", "overlap")
    num_leaves = 1            # the reference's count when given num_params
    if num_params is None:
        num_params = transformer.num_params(cfg)
        num_leaves = transformer.num_reference_leaves(cfg)
    specs = node_specs_for(cfg) if run.sketch.enabled else {}
    entries = {n: math.prod(s.layers) if isinstance(s.layers, tuple)
               else s.layers for n, s in specs.items()}
    n_entries = sum(entries.values())
    per_elem = run.sketch.k_max * 1 + 4 if run.sketch_wire_dtype == "int8" \
        else run.sketch.k_max * 4
    sketch_bytes = sum(3 * entries[n] * s.width * per_elem
                       for n, s in specs.items())
    grad_bytes = compressed_bytes(num_params, run.compression) if cs \
        else num_params * 4
    if fused:
        return _plan("fused", sketch_bytes + grad_bytes + 16,
                     ar=1 + cs_p2, p2_overlap=p2o)
    if overlap:
        return _plan("overlap", sketch_bytes + grad_bytes + 16,
                     ar=2 + cs_p2, p2_overlap=p2o)
    grad_colls = (1 + cs_p2) if cs else num_leaves
    return _plan("per_node", sketch_bytes + grad_bytes + 12,
                 ar=3 * n_entries + 3 + grad_colls)

