"""The paper's MLP trainer, §5.1 variants (counterpart of
``repro.train.paper_trainer``).

Variants:
  standard           exact backprop (baseline)
  monitor            exact backprop + monitoring-only sketches
  sketched_fixed     sketched backprop (Algorithm 2) at a fixed rank r
  sketched_adaptive  + the adaptive rank controller (Algorithm 1)

Sketching is per node: the stacked "hidden" node's entry l holds the EMA
triple of the activation feeding linear layer l+1, and that layer
rebuilds its input from the triple in its backward (``sketched_matmul``)
instead of storing it. Every update goes through
``sketches.update.proj_triple_update``: on CUDA, the ``sketch_update``
kernel for Gaussian projections or the ``psparse_update`` kernel for
p-sparsified ones, one launch per node and step. The "corange" variant
of the reference is not ported yet (ROADMAP A3, A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.paper import MLPConfig
from repro_torch.core.adaptive import (
    AdaptiveConfig, adaptive_step, init_adaptive_state,
)
from repro_torch.core.monitor import (
    init_monitor_state, monitor_record, tree_metrics,
)
from repro_torch.core.sketch import SketchConfig
from repro_torch.device import resolve_device
from repro_torch.models.mlp import _act, mlp_init
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, init_adamw, sgd_update,
)
from repro_torch.sketches.linear import sketched_matmul
from repro_torch.sketches.node import SketchNode
from repro_torch.sketches.psparse import init_psparse_projections
from repro_torch.sketches.tree import (
    NodeTree, gaussian_projections, refresh_tree, tree_to,
)
from repro_torch.sketches.update import proj_triple_update

Tensor = torch.Tensor

VARIANTS = ("standard", "monitor", "sketched_fixed", "sketched_adaptive")
SKETCHED = ("sketched_fixed", "sketched_adaptive")


def _check_variant(variant: str) -> None:
    if variant == "corange":
        raise NotImplementedError(
            "the corange variant is not ported yet: ROADMAP A3/A7 "
            "(core/corange.py, lowrank_grad_matmul)")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def init_mlp_sketch(gen: torch.Generator, cfg: MLPConfig,
                    scfg: SketchConfig, variant: str) -> NodeTree:
    """The paper MLP's tree: one stacked "hidden" node, at rank
    ``scfg.rank``, on the generator's device. Draws: the projections
    (three Gaussian matrices or 12 psparse coefficients), then psi."""
    _check_variant(variant)
    n_nodes, d, k_max = cfg.num_hidden_layers, cfg.d_hidden, scfg.k_max
    dev = gen.device
    if scfg.proj_kind == "psparse":
        proj = init_psparse_projections(gen, cfg.batch_size, k_max,
                                        scfg.proj_density)
    else:
        proj = gaussian_projections(gen, cfg.batch_size, k_max)
    node = SketchNode(
        x=torch.zeros((n_nodes, d, k_max), device=dev),
        y=torch.zeros((n_nodes, d, k_max), device=dev),
        z=torch.zeros((n_nodes, d, k_max), device=dev),
        psi=torch.randn((n_nodes, k_max), generator=gen, device=dev))
    return NodeTree(nodes={"hidden": node}, proj=proj,
                    rank=torch.tensor(scfg.rank, dtype=torch.int32,
                                      device=dev),
                    seed=gen.initial_seed())


def sketched_forward(params, x: Tensor, sk: NodeTree, cfg: MLPConfig,
                     scfg: SketchConfig, variant: str):
    """(logits, new tree). Node l's triple is updated on the activation
    feeding layer l+1; the sketched variants then consume the updated
    triple in that layer's backward, the monitor variant only keeps it."""
    act = _act(cfg.activation)
    k_active = sk.k_active
    hidden = sk.nodes["hidden"]
    # psparse projections materialise omega: once a step, not per layer
    omega = sk.proj["omega"] if variant in SKETCHED else None
    n = len(params)
    h = x
    new = ([], [], [])
    for i, p in enumerate(params):
        if i >= 1 and variant != "standard":
            l = i - 1
            triple = proj_triple_update(
                hidden.x[l], hidden.y[l], hidden.z[l], h, sk.proj,
                hidden.psi[l], scfg.beta, k_active)
            for acc, t in zip(new, triple):
                acc.append(t)
            if omega is not None:
                z = sketched_matmul(h, p["w"], *triple, omega, k_active,
                                    scfg.recon_mode, scfg.ridge,
                                    True) + p["bias"]
            else:
                z = h @ p["w"] + p["bias"]
        else:
            z = h @ p["w"] + p["bias"]
        h = act(z) if i < n - 1 else z
    if new[0]:
        hidden = dataclasses.replace(hidden, x=torch.stack(new[0]),
                                     y=torch.stack(new[1]),
                                     z=torch.stack(new[2]))
    return h, dataclasses.replace(sk, nodes={"hidden": hidden},
                                  step=sk.step + 1)


def plain_forward(params, x: Tensor, cfg: MLPConfig) -> Tensor:
    act = _act(cfg.activation)
    h = x
    n = len(params)
    for i, p in enumerate(params):
        z = h @ p["w"] + p["bias"]
        h = act(z) if i < n - 1 else z
    return h


def ce_loss(logits: Tensor, y: Tensor) -> Tensor:
    ls = torch.log_softmax(logits.float(), dim=-1)
    return -ls.gather(1, y[:, None]).mean()


def make_step(cfg: MLPConfig, scfg: SketchConfig, variant: str,
              opt_cfg: AdamWConfig) -> Callable:
    """step(params, opt, sk, x, y) -> (params, opt, new_sk, loss)."""
    _check_variant(variant)

    def step(params, opt, sk, x, y):
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                for p in params]
        if variant == "standard":
            logits, new_sk = plain_forward(live, x, cfg), sk
        else:
            logits, new_sk = sketched_forward(live, x, sk, cfg, scfg,
                                              variant)
        loss = ce_loss(logits, y)
        keys = [sorted(p) for p in live]
        flat = torch.autograd.grad(
            loss, [p[k] for p, ks in zip(live, keys) for k in ks])
        it = iter(flat)
        grads = [{k: next(it) for k in ks} for ks in keys]
        with torch.no_grad():
            if cfg.optimizer == "adam":
                params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
            else:
                params = sgd_update(params, grads, opt_cfg.lr)
        return params, opt, new_sk, loss.detach()

    return step


@dataclasses.dataclass
class PaperTrainResult:
    params: Any
    history: list
    sketch: Any
    monitor: Any


def train(cfg: MLPConfig, scfg: SketchConfig, variant: str, *, steps: int,
          batch_fn: Callable, eval_fn: Callable | None = None, seed: int = 0,
          steps_per_epoch: int = 50, adaptive: AdaptiveConfig | None = None,
          monitor_window: int = 64, params=None, sketch: NodeTree | None = None,
          device=None) -> PaperTrainResult:
    """The generic training loop: ``batch_fn(step) -> (x, y)``,
    ``eval_fn(params) -> dict``. Runs on ``device`` (the CUDA device
    unless named). ``params`` and ``sketch`` replace the ones drawn from
    ``seed`` (weights first, then the tree), so a caller can start from
    another package's numbers. Adam takes b2=0.999; the adaptive
    controller runs each epoch on the training loss of its last step."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if params is None:
        params = mlp_init(gen, cfg)
    params = [{k: v.to(device) for k, v in p.items()} for p in params]
    sk = (tree_to(sketch, device) if sketch is not None
          else init_mlp_sketch(gen, cfg, scfg, variant))
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    opt = init_adamw(params, opt_cfg)
    astate = init_adaptive_state()
    monitor = init_monitor_state(monitor_window, cfg.num_hidden_layers,
                                 device)
    step = make_step(cfg, scfg, variant, opt_cfg)
    history = []
    for s in range(steps):
        x, y = batch_fn(s)
        params, opt, sk, loss = step(params, opt, sk, x.to(device),
                                     y.to(device))
        rec = {"step": s, "loss": float(loss), "rank": int(sk.rank)}
        if variant != "standard":
            monitor = monitor_record(monitor, tree_metrics(sk))
        if eval_fn is not None and (s + 1) % steps_per_epoch == 0:
            rec.update(eval_fn(params))
            if adaptive is not None and variant == "sketched_adaptive":
                astate, new_rank, changed = adaptive_step(
                    astate, rec["rank"], rec["loss"], adaptive)
                sk = dataclasses.replace(sk, rank=torch.tensor(
                    new_rank, dtype=torch.int32, device=device))
                if changed:
                    # Alg. 1 "reinitialize matrices": zero the sketches,
                    # draw new projections and psi; no shape changes
                    sk = refresh_tree(sk)
        history.append(rec)
    return PaperTrainResult(params=params, history=history, sketch=sk,
                            monitor=monitor)


def accuracy(params, cfg: MLPConfig, x: Tensor, y: Tensor) -> float:
    with torch.no_grad():
        logits = plain_forward(params, x, cfg)
    return float((torch.argmax(logits, -1) == y).float().mean())
