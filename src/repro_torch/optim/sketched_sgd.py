"""SketchedSGD-style gradient compression over a count sketch
(counterpart of ``repro.optim.sketched_sgd``), the single-worker case.

Per step, in flat-vector space:

    u <- m * u + g                    momentum accumulator
    v <- v + u                        error-feedback accumulator
    S <- insert(0, v)                 one linear sketch of the residual
                                      (int8 wire: S <- dequant(quant(S)))
    cand <- topk(S, p2 * k)           heavy-hitter nomination (p2 > 0):
    vals <- v[cand]                   exact residual values at them
    update <- top_k(vals, k)          the k winners (p2 == 0: the top k
                                      of S at their estimates)
    v <- v - update                   unsent mass stays in v
    u <- u * (1 - transmitted)

so ``v_new + update == v_pre`` exactly away from the k coordinates. The
sketch, top-k and quantisation go through the kernels ``csvec_insert``,
``csvec_topk`` and ``csvec_quant`` (plain versions on CPU tensors).

The gradient tree is flattened in the order of a ``FlatLayout``; the LM
step passes the reference's ``ravel_pytree`` order
(``models.transformer.flat_paths``), so hash coefficients injected from
the reference put every coordinate in the same buckets.

Data parallel (``train.step``): each worker's ``countsketch_local``
sketches its own residual, the step merges the tables, and
``countsketch_finish_dp`` recovers the update once from the merged table
(the p2 round psums the workers' exact values at the common candidates)
and takes each worker's new {u, v} from its own local state.

Memory: at tinyllama-1.1b's D = 1.1e9 each flat vector is 4.4 GB. The
step makes u, v_pre and the dense update, and derives the new v and u
from v_pre and u in place at the k sent coordinates (both are this
step's fresh tensors; the caller's error-feedback state is not touched),
instead of two more full copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.countsketch.csvec import (
    CSVec, hash_params, quantized_table_bytes, select_topk, table_bytes,
)
from repro_torch.kernels.csvec_insert import csvec_insert
from repro_torch.kernels.csvec_quant import csvec_quant
from repro_torch.kernels.csvec_topk import csvec_topk
from repro_torch.optim.flat import FlatLayout, tree_leaves

Tensor = torch.Tensor


def flat_dim(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def init_countsketch_state(params) -> dict:
    """Dense flat momentum (u) and error-feedback (v) accumulators."""
    leaves = tree_leaves(params)
    d = sum(p.numel() for p in leaves)
    dev = leaves[0].device
    return {"u": torch.zeros(d, dtype=torch.float32, device=dev),
            "v": torch.zeros(d, dtype=torch.float32, device=dev)}


def grad_csvec(cfg, dim: int, device) -> CSVec:
    """The step's empty sketch. Its hash coefficients come from a CPU
    generator seeded with ``cfg.cs_seed``, so every worker and device
    builds the same family; they are not the reference's (``jax.random``
    draws other bits from the same seed)."""
    gen = torch.Generator().manual_seed(cfg.cs_seed)
    return CSVec(table=torch.zeros((cfg.cs_rows, cfg.cs_cols),
                                   dtype=torch.float32, device=device),
                 params=hash_params(gen, cfg.cs_rows), dim=int(dim))


@dataclasses.dataclass
class CountsketchLocal:
    """Worker-local compression state at the merge boundary."""

    cs: CSVec           # table holds the wire values (dequantised grid
    #                     values under wire_dtype="int8", raw f32 else)
    v_pre: Tensor       # error-feedback residual including this grad
    u: Tensor           # momentum accumulator
    unravel: Callable   # flat -> gradient tree (views)
    cfg: Any            # geometry-resolved CompressionConfig
    dim: int


def countsketch_local(grads, err_state, cfg, layout: FlatLayout | None = None,
                      params=None, out: dict | None = None
                      ) -> CountsketchLocal:
    """Everything before the table merge: momentum and error feedback in
    flat space, the sketch of the residual, and (int8 wire) its
    per-row quantise/dequantise. ``params`` overrides the hash
    coefficients of ``grad_csvec`` (the tests inject the reference's);
    ``out`` ({"u", "v"} (D,) tensors) receives u and v_pre instead of
    new tensors."""
    from repro_torch.optim.compression import resolve_countsketch

    layout = layout or FlatLayout(grads)
    flat = layout.ravel(grads)
    cfg = resolve_countsketch(cfg, layout.dim)
    out = out or {"u": None, "v": None}
    u = torch.mul(err_state["u"], cfg.cs_momentum, out=out["u"])
    u += flat
    del flat
    v_pre = torch.add(err_state["v"], u, out=out["v"])
    cs = grad_csvec(cfg, layout.dim, v_pre.device)
    if params is not None:
        cs = dataclasses.replace(cs, params=params)
    cs = dataclasses.replace(cs, table=csvec_insert(cs.table, cs.params,
                                                    v_pre))
    if cfg.wire_dtype == "int8":
        _, _, dhat, _ = csvec_quant(cs.table, dhat_only=True)
        cs = dataclasses.replace(cs, table=dhat)
    return CountsketchLocal(cs=cs, v_pre=v_pre, u=u, unravel=layout.unravel,
                            cfg=cfg, dim=layout.dim)


def _recover_candidates(cs: CSVec, k: int, cfg):
    """Top-k coordinates of the merged sketch by |median estimate|,
    (vals, idx) by descending magnitude."""
    return csvec_topk(cs.table, cs.params, cs.dim, k)


def countsketch_nominate(local: CountsketchLocal, merged: CSVec):
    """The p2 round's first half: p2*k candidates from the merged table
    and this worker's exact residual values at them."""
    cfg, dim = local.cfg, local.dim
    n_cand = min(cfg.cs_p2 * min(cfg.cs_k, dim), dim)
    _, cand = _recover_candidates(merged, n_cand, cfg)
    return cand, local.v_pre[cand]


def _dense_update(local: CountsketchLocal, sel_idx: Tensor, sel_val: Tensor):
    update = torch.zeros(local.dim, dtype=torch.float32,
                         device=local.v_pre.device)
    update[sel_idx] = sel_val
    return update


def _new_state(local: CountsketchLocal, sel_idx: Tensor, sel_val: Tensor):
    """The new {u, v}: v_new = v_pre - update and u_new = u * (1 - sent),
    taken in place on this step's v_pre and u at the k sent coordinates
    (everywhere else both are unchanged)."""
    new_v = local.v_pre
    new_v[sel_idx] -= sel_val
    new_u = local.u
    new_u[sel_idx[sel_val != 0.0]] = 0.0
    return {"u": new_u, "v": new_v}


def _apply_update(local: CountsketchLocal, sel_idx: Tensor, sel_val: Tensor):
    """The dense update and the new {u, v}."""
    return (_dense_update(local, sel_idx, sel_val),
            _new_state(local, sel_idx, sel_val))


def _stats(local: CountsketchLocal, merged: CSVec, extra: int = 0) -> dict:
    wire = (quantized_table_bytes(merged)
            if local.cfg.wire_dtype == "int8" else table_bytes(merged))
    wire += extra
    return {"wire_bytes": float(wire),
            "compression_ratio": wire / (local.dim * 4)}


def _select(local: CountsketchLocal, cand, exact, workers):
    """The top k of the merged exact values (ties to the earlier
    candidate, as ``lax.top_k``): (coordinates, values / workers)."""
    exact = exact / workers
    pos = select_topk(exact.abs(), min(local.cfg.cs_k, local.dim))
    return cand[pos], exact[pos]


def countsketch_complete(local: CountsketchLocal, merged: CSVec, cand,
                         exact, *, workers):
    """The p2 round's second half: the top k of the merged exact values
    (ties to the earlier candidate, as ``lax.top_k``), the update and
    the new {u, v}. Returns ``(update (dim,), sel_idx (k,), sel_val
    (k,), state, stats)``."""
    sel_idx, sel_val = _select(local, cand, exact, workers)
    update, state = _apply_update(local, sel_idx, sel_val)
    return (update, sel_idx, sel_val, state,
            _stats(local, merged, cand.shape[0] * 4))


def countsketch_finish(local: CountsketchLocal, merged: CSVec, *,
                       workers=1.0):
    """Everything after the table merge: heavy-hitter recovery (with the
    p2 round when ``cs_p2 > 0``), the update as a gradient tree of views
    into one flat vector, the new {u, v} and wire stats."""
    cfg, dim = local.cfg, local.dim
    if cfg.cs_p2 > 0:
        cand, exact = countsketch_nominate(local, merged)
        update, _, _, state, stats = countsketch_complete(
            local, merged, cand, exact, workers=workers)
        return local.unravel(update), state, stats
    est, sel_idx = _recover_candidates(merged, min(cfg.cs_k, dim), cfg)
    update, state = _apply_update(local, sel_idx, est / workers)
    return local.unravel(update), state, _stats(local, merged)


def countsketch_nominate_dp(locals_: list, merged: CSVec):
    """The p2 round's first half over the workers: the candidates, the
    same for every worker (the merged table is), and each worker's exact
    residual values at them."""
    cfg, dim = locals_[0].cfg, locals_[0].dim
    n_cand = min(cfg.cs_p2 * min(cfg.cs_k, dim), dim)
    _, cand = _recover_candidates(merged, n_cand, cfg)
    return cand, [local.v_pre[cand] for local in locals_]


def countsketch_complete_dp(locals_: list, merged: CSVec, cand, exact, *,
                            workers):
    """The p2 round's second half over the workers, from the psum of
    their exact values: ``(update (dim,), sel_idx, sel_val, [each
    worker's new {u, v}], stats)``, as ``countsketch_complete``."""
    sel_idx, sel_val = _select(locals_[0], cand, exact, workers)
    update = _dense_update(locals_[0], sel_idx, sel_val)
    states = [_new_state(local, sel_idx, sel_val) for local in locals_]
    return (update, sel_idx, sel_val, states,
            _stats(locals_[0], merged, cand.shape[0] * 4))


def countsketch_finish_dp(locals_: list, merged: CSVec, *, workers):
    """``countsketch_finish`` across the workers, the reference's with
    ``axis_name``: the update (a gradient tree of views into one flat
    vector) recovered once from the merged table, with the p2 round's
    psum of exact values when ``cs_p2 > 0``, and each worker's new
    {u, v} from its own local state. Returns (update tree, states,
    stats)."""
    from repro_torch.parallel.collectives import traced_psum

    local, cfg = locals_[0], locals_[0].cfg
    if cfg.cs_p2 > 0:
        cand, exacts = countsketch_nominate_dp(locals_, merged)
        exact = traced_psum(exacts, name="cs_p2_values")
        update, _, _, states, stats = countsketch_complete_dp(
            locals_, merged, cand, exact, workers=workers)
        return local.unravel(update), states, stats
    est, sel_idx = _recover_candidates(merged, min(cfg.cs_k, local.dim), cfg)
    sel_val = est / workers
    states = [_new_state(lc, sel_idx, sel_val) for lc in locals_]
    return (local.unravel(_dense_update(local, sel_idx, sel_val)), states,
            _stats(local, merged))


def compress_grads_countsketch(grads, err_state, cfg, *,
                               axis_name: str | None = None,
                               layout: FlatLayout | None = None,
                               params=None):
    """Returns (compressed grads tree, new {u, v} state, stats): the
    single-worker case, where the merge is the identity. One call sees
    one worker's gradients, so ``axis_name`` raises: the workers' merge
    is ``countsketch_local`` on each and ``countsketch_finish_dp``."""
    if axis_name is not None:
        raise ValueError(
            "compress_grads_countsketch compresses one worker's gradients; "
            "over a data-parallel axis train.step runs countsketch_local "
            "on each worker and countsketch_finish_dp on the merged table")
    local = countsketch_local(grads, err_state, cfg, layout, params)
    return countsketch_finish(local, local.cs)


def countsketch_wire_bytes(cfg, num_params: int = 0) -> int:
    """Per-step, per-worker bytes on the data-parallel wire (from
    ``optim.compression.compressed_bytes``)."""
    from repro_torch.optim.compression import compressed_bytes
    return compressed_bytes(num_params, cfg)
