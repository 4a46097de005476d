"""AdamW and SGD over a parameter tree (counterpart of
``repro.optim.adamw``): the paper MLP's list of dicts or the LM's nested
dict, walked as ``optim.flat.tree_leaves`` walks it. Functional, as in
the reference: each update returns new parameters and state and changes
no input.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.flat import _set_path
from repro_torch.optim.flat import get_path as _get
from repro_torch.optim.flat import leaf_paths
from repro_torch.optim.flat import tree_leaves as _leaves
from repro_torch.optim.flat import tree_like as _like

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0           # global-norm clip; 0 disables
    moment_dtype: torch.dtype = torch.float32


def init_adamw(params, cfg: AdamWConfig) -> dict:
    zeros = [torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
             for p in _leaves(params)]
    return {"m": _like(params, zeros),
            "v": _like(params, [torch.zeros_like(z) for z in zeros]),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=zeros[0].device)}


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _leaves(tree)))


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics). The global-norm clip
    scales each gradient leaf as the update reads it, so no clipped copy
    of the gradients is held. ``grads=None`` is the update with zero
    gradients, without a tree of zeros. The update consumes ``grads``:
    each leaf is set to None in it once read, so the gradients leave
    memory as the new leaves arrive and the step's peak holds the old
    and the new state, not the gradients beside them (8.5 GB at
    xlstm-1.3b)."""
    if grads is None:
        gn = torch.zeros((), dtype=torch.float32,
                         device=_leaves(params)[0].device)
        grads = _like(params, [torch.zeros((), dtype=p.dtype, device=p.device)
                               for p in _leaves(params)])
    else:
        gn = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
             if cfg.grad_clip > 0 else None)
    count = state["count"] + 1
    t = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    lr = cfg.lr * lr_scale
    new_p, new_m, new_v = [], [], []
    for path, p, m, v in zip(leaf_paths(params), _leaves(params),
                             _leaves(state["m"]), _leaves(state["v"])):
        g = _get(grads, path)
        _set_path(grads, path, None)
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(cfg.moment_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        new_p.append((pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (_like(params, new_p),
            {"m": _like(params, new_m), "v": _like(params, new_v),
             "count": count},
            {"grad_norm": gn})


def _flat_index(layout, idx: Tensor):
    """(leaf number, positions in ``idx``, offsets in the leaf) of each
    leaf of ``layout`` that the flat coordinates ``idx`` fall in."""
    start = 0
    for n, size in enumerate(layout.sizes):
        hit = ((idx >= start) & (idx < start + size)).nonzero()[:, 0]
        if hit.numel():
            yield n, hit, idx[hit] - start
        start += size


def adamw_sparse_update(params, state, cfg: AdamWConfig, lr_scale=1.0, *,
                        update: Tensor, idx: Tensor, layout):
    """AdamW for a k-sparse flat gradient (the count sketch's update,
    nonzero at the distinct coordinates ``idx`` of ``layout``'s flat
    order), in two parts as the reference's: the dense update with zero
    gradients, which needs nothing of the collective that makes
    ``update``, then the k coordinates recomputed from the state before
    the step and written over it. At every other coordinate a zero
    gradient gives the dense formulas' values, so the result is
    ``adamw_update(params, layout.unravel(update), ...)`` bit for bit.
    Returns (new_params, new_state, metrics)."""
    p0, s0, _ = adamw_update(params, None, state, cfg, lr_scale)
    gn = global_norm(layout.unravel(update))
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
             if cfg.grad_clip > 0 else None)
    t = s0["count"].to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    lr = cfg.lr * lr_scale
    g_all = update[idx]
    for n, hit, off in _flat_index(layout, idx):
        path = layout.paths[n]
        p = _get(params, path).reshape(-1)
        g = g_all[hit]
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(cfg.moment_dtype)
        m = (cfg.b1 * _get(state["m"], path).reshape(-1)[off]
             + (1 - cfg.b1) * gf)
        v = (cfg.b2 * _get(state["v"], path).reshape(-1)[off]
             + (1 - cfg.b2) * gf * gf)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p[off].float()
        _get(p0, path).view(-1)[off] = (
            pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype)
        _get(s0["m"], path).view(-1)[off] = m
        _get(s0["v"], path).view(-1)[off] = v
    return p0, s0, {"grad_norm": gn}


def sgd_update(params, grads, lr: float):
    return _like(params, [(p.float() - lr * g.float()).to(p.dtype)
                          for p, g in zip(_leaves(params), _leaves(grads))])
