"""The paper's trainers, §5 (counterpart of ``repro.train.paper_trainer``):
the MLP in its five variants, its data-parallel step, the sketched CIFAR
conv stem, the CIFAR hybrid (exact stem, sketched dense tail) and the
PINN with monitoring-only sketches.

MLP variants:
  standard           exact backprop (baseline)
  monitor            exact backprop + monitoring-only sketches
  sketched_fixed     sketched backprop (Algorithm 2) at a fixed rank r
  sketched_adaptive  + the adaptive rank controller (Algorithm 1)
  corange            sketched backprop with the Tropp co-range triple
                     (``core.corange``; provable sqrt(6)-tail bound)

Sketching is per node: the stacked "hidden" node's entry l holds the EMA
triple of the activation feeding linear layer l+1, and that layer
rebuilds its input from the triple in its backward instead of storing
it. Paper-kind updates go through ``sketches.update.proj_triple_update``:
on CUDA, the ``sketch_update`` kernel for Gaussian projections or the
``psparse_update`` kernel for p-sparsified ones, one launch per node and
step. A corange step's updates are three plain products a node, so it
launches no update kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.paper import ConvConfig, MLPConfig
from repro_torch.core.adaptive import (
    AdaptiveConfig, adaptive_step, init_adaptive_state,
)
from repro_torch.core.corange import (
    corange_reconstruct, make_corange_projections, s_of,
)
from repro_torch.core.monitor import (
    init_monitor_state, monitor_record, tree_metrics,
)
from repro_torch.core.sketch import SketchConfig
from repro_torch.device import resolve_device
from repro_torch.models.mlp import (
    _act, conv_im2col_sketched, conv_same, conv_stem_apply,
    im2col, mlp_forward, mlp_init, pinn_loss, poisson_exact, pool2,
)
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update, init_adamw, sgd_update,
)
from repro_torch.optim.flat import tree_leaves, tree_like, tree_map
from repro_torch.parallel.collectives import psum_flat_segments, traced_psum
from repro_torch.sketches.linear import sketched_matmul
from repro_torch.sketches.node import SketchNode
from repro_torch.sketches.psparse import (
    init_psparse_projections, make_psparse_corange_projections,
)
from repro_torch.sketches.registry import node_specs_for
from repro_torch.sketches.tree import (
    NodeTree, gaussian_projections, init_node_tree, refresh_tree, tree_to,
)
from repro_torch.sketches.update import (
    corange_triple_update, ema_apply_increment,
    ema_triple_update, pad_activation_rows, proj_num_tokens,
    proj_triple_increment, proj_triple_update,
)
from repro_torch.sketches.wire import tree_increment_leaves

Tensor = torch.Tensor

VARIANTS = ("standard", "monitor", "sketched_fixed", "sketched_adaptive",
            "corange")
SKETCHED = ("sketched_fixed", "sketched_adaptive")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


# -- the corange variant's low-rank gradient matmul ---------------------------


class LowRankGradMatmul(torch.autograd.Function):
    """y = x @ w, with grad_w = right @ (left^T @ g) from the
    reconstruction A~ = left @ right^T made before the call. Saves w and
    the k-wide factors, never x; the factors get no gradient."""

    @staticmethod
    def forward(ctx, x, w, left, right):
        ctx.save_for_backward(w, left, right)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        w, left, right = ctx.saved_tensors
        grad_w = right @ (left.T @ g.to(left.dtype))
        return g @ w.T, grad_w.to(w.dtype), None, None


def lowrank_grad_matmul(x: Tensor, w: Tensor, left: Tensor,
                        right: Tensor) -> Tensor:
    return LowRankGradMatmul.apply(x, w, left, right)


# -- sketch state -------------------------------------------------------------


def init_mlp_sketch(gen: torch.Generator, cfg: MLPConfig,
                    scfg: SketchConfig, variant: str) -> NodeTree:
    """The paper MLP's tree: one stacked "hidden" node, at rank
    ``scfg.rank``, on the generator's device. Draws: the projections
    (Gaussian matrices or psparse coefficients), then psi. A corange
    tree's node holds the Tropp triple (x (L, k_max, N_b), y (L, d,
    k_max), z (L, s_max, s_max)) and no psi; its core weights are the
    projections'."""
    _check_variant(variant)
    spec = node_specs_for(cfg)["hidden"]
    n_nodes, d, k_max = spec.layers, spec.width, scfg.k_max
    nb, dev = cfg.batch_size, gen.device
    psparse = scfg.proj_kind == "psparse"
    if variant == "corange":
        proj = (make_psparse_corange_projections(gen, d, nb, k_max,
                                                 scfg.proj_density)
                if psparse else make_corange_projections(gen, d, nb, k_max))
        s = s_of(k_max)
        node = SketchNode(x=torch.zeros((n_nodes, k_max, nb), device=dev),
                          y=torch.zeros((n_nodes, d, k_max), device=dev),
                          z=torch.zeros((n_nodes, s, s), device=dev),
                          psi=torch.zeros((n_nodes, 0), device=dev),
                          kind="corange")
    else:
        proj = (init_psparse_projections(gen, nb, k_max, scfg.proj_density)
                if psparse else gaussian_projections(gen, nb, k_max))
        node = SketchNode(
            x=torch.zeros((n_nodes, d, k_max), device=dev),
            y=torch.zeros((n_nodes, d, k_max), device=dev),
            z=torch.zeros((n_nodes, d, k_max), device=dev),
            psi=torch.randn((n_nodes, k_max), generator=gen, device=dev))
    return NodeTree(nodes={"hidden": node}, proj=proj,
                    rank=torch.tensor(scfg.rank, dtype=torch.int32,
                                      device=dev),
                    seed=gen.initial_seed())


# -- forwards -----------------------------------------------------------------


def sketched_forward(params, x: Tensor, sk: NodeTree, cfg: MLPConfig,
                     scfg: SketchConfig, variant: str, *,
                     premerged: bool = False):
    """(logits, new tree). Node l's triple is updated on the activation
    feeding layer l+1; the sketched variants then consume the updated
    triple in that layer's backward, the monitor variant only keeps it.
    With ``premerged`` the tree already holds this step's triples (the
    data-parallel step merged and folded them in): they are consumed as
    they are and the tree comes back unchanged. The corange variant runs
    ``_corange_forward``'s batched form."""
    if variant == "corange":
        if premerged:
            raise ValueError("the corange variant has no data-parallel "
                             "step")
        return _corange_forward(params, x, sk, cfg, scfg, batched=True)
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
            if premerged:
                triple = (hidden.x[l], hidden.y[l], hidden.z[l])
            else:
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
    if premerged:
        return h, sk
    if new[0]:
        hidden = dataclasses.replace(hidden, x=torch.stack(new[0]),
                                     y=torch.stack(new[1]),
                                     z=torch.stack(new[2]))
    return h, dataclasses.replace(sk, nodes={"hidden": hidden},
                                  step=sk.step + 1)


def _observed(params, x: Tensor, cfg: MLPConfig) -> list[Tensor]:
    """The activations each node observes (the input to layers 1..L),
    from a sweep without gradients: the primal never depends on a
    triple, so these are the values the differentiable chain sees."""
    act = _act(cfg.activation)
    obs, h = [], x
    with torch.no_grad():
        for i, p in enumerate(params[:-1]):
            h = act(h @ p["w"] + p["bias"])
            obs.append(h)
    return obs


def _corange_forward(params, x: Tensor, sk: NodeTree, cfg: MLPConfig,
                     scfg: SketchConfig, *, batched: bool):
    """The corange variant's forward: (logits, new tree).

    ``batched=True`` (``sketched_forward``'s form) runs in three phases:
    the observed activations from a sweep without gradients; one update
    of the (L,)-stacked triple and ONE batched reconstruction over it;
    then the differentiable chain consuming each layer's (left, right)
    in ``lowrank_grad_matmul``. ``batched=False`` is the sequential
    update-reconstruct-consume loop, the reference that the batched form
    is held to."""
    act = _act(cfg.activation)
    k_active = sk.k_active
    hidden = sk.nodes["hidden"]
    n = len(params)
    if batched:
        obs = torch.stack(_observed(params, x, cfg))         # (L, N_b, d)
        xcs, ycs, zcs = corange_triple_update(
            hidden.x, hidden.y, hidden.z, obs, sk.proj, scfg.beta, k_active)
        rec = corange_reconstruct(xcs, ycs, zcs, sk.proj, k_active)
        lefts, rights = rec.left, rec.right
    else:
        lefts, rights, new = [], [], ([], [], [])
    h = x
    for i, p in enumerate(params):
        if i >= 1:
            l = i - 1
            if not batched:
                triple = corange_triple_update(
                    hidden.x[l], hidden.y[l], hidden.z[l], h, sk.proj,
                    scfg.beta, k_active)
                for acc, t in zip(new, triple):
                    acc.append(t)
                rec = corange_reconstruct(*triple, sk.proj, k_active)
                lefts.append(rec.left)
                rights.append(rec.right)
            z = lowrank_grad_matmul(h, p["w"], lefts[l].to(h.dtype),
                                    rights[l].to(h.dtype)) + p["bias"]
        else:
            z = h @ p["w"] + p["bias"]
        h = act(z) if i < n - 1 else z
    if not batched:
        xcs, ycs, zcs = (torch.stack(t) for t in new)
    hidden = dataclasses.replace(hidden, x=xcs, y=ycs, z=zcs)
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


def value_and_grad(loss_fn: Callable, params):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)``, grads
    shaped like ``params``; the loss comes back detached."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), aux, tree_like(params, list(grads))


def _optimize(params, grads, opt, opt_cfg: AdamWConfig,
              optimizer: str = "adam"):
    with torch.no_grad():
        if optimizer == "adam":
            params, opt, _ = adamw_update(params, grads, opt, opt_cfg)
        else:
            params = sgd_update(params, grads, opt_cfg.lr)
    return params, opt


def make_step(cfg: MLPConfig, scfg: SketchConfig, variant: str,
              opt_cfg: AdamWConfig) -> Callable:
    """step(params, opt, sk, x, y) -> (params, opt, new_sk, loss)."""
    _check_variant(variant)

    def loss_fn(p, sk, x, y):
        if variant == "standard":
            return ce_loss(plain_forward(p, x, cfg), y), sk
        logits, new_sk = sketched_forward(p, x, sk, cfg, scfg, variant)
        return ce_loss(logits, y), new_sk

    def step(params, opt, sk, x, y):
        loss, new_sk, grads = value_and_grad(
            lambda p: loss_fn(p, sk, x, y), params)
        params, opt = _optimize(params, grads, opt, opt_cfg, cfg.optimizer)
        return params, opt, new_sk, loss

    return step


# -- the data-parallel MLP step -----------------------------------------------


def mlp_sketch_increments(params, x: Tensor, sk: NodeTree, cfg: MLPConfig,
                          scfg: SketchConfig) -> NodeTree:
    """The data-parallel step's first phase for the paper MLP: each
    node's local masked (1-beta)-scaled increments on the activations of
    a sweep without gradients, stacked into the "hidden" node's x/y/z,
    the step counter advanced. Merging these over the workers and
    folding them in (``ema_apply_increment``) gives the per-node
    layout's tree."""
    hidden = sk.nodes["hidden"]
    k_active = sk.k_active
    obs = _observed(params, x, cfg)
    incs = [proj_triple_increment(hidden.x[l], hidden.y[l], hidden.z[l],
                                  a, sk.proj, hidden.psi[l], scfg.beta,
                                  k_active)
            for l, a in enumerate(obs)]
    node = dataclasses.replace(hidden, x=torch.stack([i[0] for i in incs]),
                               y=torch.stack([i[1] for i in incs]),
                               z=torch.stack([i[2] for i in incs]))
    return dataclasses.replace(sk, nodes={"hidden": node}, step=sk.step + 1)


def make_dp_step(cfg: MLPConfig, scfg: SketchConfig, variant: str,
                 opt_cfg: AdamWConfig, workers: int, *,
                 collective: str = "overlap") -> Callable:
    """The W-way data-parallel MLP step (the reference's shard_map step
    over a ``workers``-wide axis), its W workers in one process as the
    LM's (``repro_torch.parallel``): the state is held once, worker w
    takes rows [w B/W, (w+1) B/W) of the batch.

      * ``collective="per_node"``: each node's W increments merged (one
        collective a node entry) before that node is consumed, then the
        loss and each gradient leaf averaged;
      * ``collective="overlap"``: the whole increment tree merged in one
        flat-segment collective and folded in, consumed pre-merged by
        the forward-backward, then gradients, loss and a worker counter
        merged in a second.

    A merge is the ordered fold over the workers, so the sketch trees,
    the loss and the gradients are equal bit for bit between the two
    layouts at any W. The corange and standard variants have no
    data-parallel step (``ValueError``, as in the reference)."""
    if variant not in ("sketched_fixed", "sketched_adaptive", "monitor"):
        raise ValueError(
            f"make_dp_step supports the paper-kind variants; got "
            f"{variant!r} (corange's overlap coverage is the "
            f"subsystem-level differential)")
    if collective not in ("per_node", "overlap"):
        raise ValueError(f"collective must be 'per_node' or 'overlap', got "
                         f"{collective!r}")
    W, beta = workers, scfg.beta

    def merge_sketch(sk, incs):
        if collective == "overlap":
            m = psum_flat_segments([tree_increment_leaves(t) for t in incs],
                                   name="overlap_sketch",
                                   barrier=True)["hidden"]
        else:
            m = {a: torch.stack([
                traced_psum([getattr(t.nodes["hidden"], a)[l] for t in incs],
                            name=f"node_hidden_{a}")
                for l in range(cfg.num_hidden_layers)]) for a in "xyz"}
        old, ka = sk.nodes["hidden"], sk.k_active
        node = dataclasses.replace(
            incs[0].nodes["hidden"],
            **{a: ema_apply_increment(getattr(old, a), m[a], beta, ka)
               for a in "xyz"})
        return dataclasses.replace(incs[0], nodes={"hidden": node})

    def step(params, opt, sk, x, y):
        if x.shape[0] % W:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {W} workers")
        b = x.shape[0] // W
        xs = [x[w * b:(w + 1) * b] for w in range(W)]
        ys = [y[w * b:(w + 1) * b] for w in range(W)]
        new_sk = merge_sketch(sk, [mlp_sketch_increments(params, xw, sk, cfg,
                                                         scfg) for xw in xs])
        outs = []
        for xw, yw in zip(xs, ys):
            loss, _, grads = value_and_grad(lambda p: (ce_loss(
                sketched_forward(p, xw, new_sk, cfg, scfg, variant,
                                 premerged=True)[0], yw), None), params)
            outs.append({"n": torch.ones((), device=x.device),
                         "scalars": loss[None], "grads": grads})
        if collective == "overlap":
            mg = psum_flat_segments(outs, name="overlap_grad")
            n = mg["n"]
            loss, grads = mg["scalars"][0] / n, tree_map(lambda g: g / n,
                                                         mg["grads"])
        else:
            loss = traced_psum([o["scalars"][0] for o in outs],
                               name="pmean_loss") / W
            grads = tree_like(params, [
                traced_psum(gs, name="pmean_grads") / W
                for gs in zip(*(tree_leaves(o["grads"]) for o in outs))])
        params, opt = _optimize(params, grads, opt, opt_cfg, cfg.optimizer)
        return params, opt, new_sk, loss

    return step


# -- the training loops -------------------------------------------------------


@dataclasses.dataclass
class PaperTrainResult:
    params: Any
    history: list
    sketch: Any
    monitor: Any


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def train(cfg: MLPConfig, scfg: SketchConfig, variant: str, *, steps: int,
          batch_fn: Callable, eval_fn: Callable | None = None, seed: int = 0,
          steps_per_epoch: int = 50, adaptive: AdaptiveConfig | None = None,
          monitor_window: int = 64, params=None,
          sketch: NodeTree | None = None, device=None) -> PaperTrainResult:
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
    params = _to(params, device)
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


# -- the sketched conv stem (XConv im2col factoring) -------------------------


def conv_init(gen: torch.Generator, cfg: ConvConfig) -> dict:
    """Two SAME stride-1 3x3 convs (C -> 8 -> 16), a 2x2 max-pool after
    each, and an exact linear head, zero at init (the pooled ReLU
    features come in large, so logits grow from 0). Only the convs are
    sketched, one node a stage. Draws: c1, then c2."""
    dev = gen.device
    feat = (cfg.hw // 4) ** 2 * 16
    return {
        "c1": (torch.randn((3, 3, cfg.channels, 8), generator=gen, device=dev)
               * (2.0 / (9 * cfg.channels)) ** 0.5).to(cfg.dtype),
        "c2": (torch.randn((3, 3, 8, 16), generator=gen, device=dev)
               * (2.0 / 72) ** 0.5).to(cfg.dtype),
        "head": {"w": torch.zeros((feat, cfg.d_out), dtype=cfg.dtype,
                                  device=dev),
                 "bias": torch.zeros((cfg.d_out,), dtype=cfg.dtype,
                                     device=dev)},
    }


def init_conv_sketch(gen: torch.Generator, cfg: ConvConfig,
                     scfg: SketchConfig) -> NodeTree:
    """The conv stem's tree (``init_node_tree`` over its registered
    specs, ``models.mlp.conv_node_specs``)
    bound to ``cfg.num_tokens`` = B * hw^2 rows, stage 1's im2col rows;
    stage 2 zero-pads its B * (hw/2)^2 rows up to it. At rank
    ``scfg.rank``."""
    tree = init_node_tree(gen, node_specs_for(cfg), cfg.num_tokens,
                          scfg.k_max, proj_kind=scfg.proj_kind,
                          proj_density=scfg.proj_density)
    return dataclasses.replace(tree, rank=torch.tensor(
        scfg.rank, dtype=torch.int32, device=gen.device))


def _head(params, h: Tensor) -> Tensor:
    h = h.reshape(h.shape[0], -1)
    return h @ params["head"]["w"] + params["head"]["bias"]


def conv_plain_forward(params, img: Tensor, cfg: ConvConfig) -> Tensor:
    h = img
    for wkey in ("c1", "c2"):
        h = pool2(torch.relu(conv_same(h, params[wkey])))
    return _head(params, h)


def conv_sketched_forward(params, img: Tensor, sk: NodeTree, cfg: ConvConfig,
                          scfg: SketchConfig):
    """(logits, new tree). Each stage updates its node's triple on its
    zero-padded im2col patches (``proj_triple_update``: one
    ``sketch_update`` or ``psparse_update`` launch a stage), then
    consumes the fresh triple through ``conv_im2col_sketched``."""
    k_active = sk.k_active
    num_tokens = proj_num_tokens(sk.proj)
    omega = sk.proj["omega"]          # psparse: materialised once a step
    new_nodes = dict(sk.nodes)
    h = img
    for name, wkey in (("conv1", "c1"), ("conv2", "c2")):
        node = sk.nodes[name]
        patches = pad_activation_rows(im2col(h.detach(), 3, 3).float(),
                                      num_tokens)
        xc, yc, zc = proj_triple_update(node.x, node.y, node.z, patches,
                                        sk.proj, node.psi, scfg.beta,
                                        k_active)
        node = dataclasses.replace(node, x=xc, y=yc, z=zc)
        new_nodes[name] = node
        h = conv_im2col_sketched(h, params[wkey], node, sk.proj, k_active,
                                 recon_mode=scfg.recon_mode,
                                 ridge=scfg.ridge, factored=True,
                                 omega=omega)
        h = pool2(torch.relu(h))
    return _head(params, h), dataclasses.replace(sk, nodes=new_nodes,
                                                 step=sk.step + 1)


def make_conv_step(cfg: ConvConfig, scfg: SketchConfig, variant: str,
                   opt_cfg: AdamWConfig) -> Callable:
    """step(params, opt, sk, img, y): ``standard`` exact, any other
    variant the sketched stem; AdamW."""
    def loss_fn(p, sk, x, y):
        if variant == "standard":
            return ce_loss(conv_plain_forward(p, x, cfg), y), sk
        logits, new_sk = conv_sketched_forward(p, x, sk, cfg, scfg)
        return ce_loss(logits, y), new_sk

    def step(params, opt, sk, x, y):
        loss, new_sk, grads = value_and_grad(
            lambda p: loss_fn(p, sk, x, y), params)
        params, opt = _optimize(params, grads, opt, opt_cfg)
        return params, opt, new_sk, loss

    return step


def _loop(step, params, opt, sk, steps: int, batch_fn: Callable, device,
          monitor, record: bool) -> tuple:
    history = []
    for s in range(steps):
        x, y = batch_fn(s)
        params, opt, sk, loss = step(params, opt, sk, x.to(device),
                                     y.to(device))
        history.append({"step": s, "loss": float(loss),
                        "rank": int(sk.rank)})
        if record:
            monitor = monitor_record(monitor, tree_metrics(sk))
    return PaperTrainResult(params=params, history=history, sketch=sk,
                            monitor=monitor)


def train_conv(cfg: ConvConfig, scfg: SketchConfig, variant: str, *,
               steps: int, batch_fn: Callable, seed: int = 0,
               monitor_window: int = 64, params=None,
               sketch: NodeTree | None = None,
               device=None) -> PaperTrainResult:
    """The conv stem's loop, ``train``'s contract: ``batch_fn(step) ->
    (img (B, hw, hw, C), labels (B,))``; draws weights, then the tree."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = _to(params if params is not None else conv_init(gen, cfg),
                 device)
    sk = (tree_to(sketch, device) if sketch is not None
          else init_conv_sketch(gen, cfg, scfg))
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    return _loop(make_conv_step(cfg, scfg, variant, opt_cfg), params,
                 init_adamw(params, opt_cfg), sk, steps, batch_fn, device,
                 init_monitor_state(monitor_window, len(sk.nodes), device),
                 variant != "standard")


# -- the CIFAR hybrid: exact conv stem, sketched dense tail ------------------


def make_hybrid_step(cfg: MLPConfig, scfg: SketchConfig, variant: str,
                     opt_cfg: AdamWConfig) -> Callable:
    """step(params, opt, sk, img, y) with params {"stem", "mlp"}: the stem
    (``conv_stem_apply``) trains with exact gradients, the dense tail
    through ``sketched_forward`` (the reference's
    ``benchmarks/bench_cifar_hybrid.py::_make_step``, joint regime)."""
    _check_variant(variant)

    def loss_fn(p, sk, img, y):
        feat = conv_stem_apply(p["stem"], img)
        if variant == "standard":
            return ce_loss(plain_forward(p["mlp"], feat, cfg), y), sk
        logits, new_sk = sketched_forward(p["mlp"], feat, sk, cfg, scfg,
                                          variant)
        return ce_loss(logits, y), new_sk

    def step(params, opt, sk, img, y):
        loss, new_sk, grads = value_and_grad(
            lambda p: loss_fn(p, sk, img, y), params)
        params, opt = _optimize(params, grads, opt, opt_cfg)
        return params, opt, new_sk, loss

    return step


def hybrid_accuracy(params, cfg: MLPConfig, img: Tensor, y: Tensor) -> float:
    with torch.no_grad():
        return accuracy(params["mlp"], cfg,
                        conv_stem_apply(params["stem"], img), y)


def train_hybrid(cfg: MLPConfig, scfg: SketchConfig, variant: str, *,
                 steps: int, batch_fn: Callable, params: dict,
                 sketch: NodeTree | None = None, seed: int = 0,
                 monitor_window: int = 64, device=None) -> PaperTrainResult:
    """The hybrid's loop from ``params`` {"stem", "mlp"}: ``batch_fn(step)
    -> (img (B, 32, 32, 3), labels)``; the tail's tree drawn from
    ``seed`` unless given."""
    device = resolve_device(device)
    params = _to(params, device)
    if sketch is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        sk = init_mlp_sketch(gen, cfg, scfg, variant)
    else:
        sk = tree_to(sketch, device)
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999)
    return _loop(make_hybrid_step(cfg, scfg, variant, opt_cfg), params,
                 init_adamw(params, opt_cfg), sk, steps, batch_fn, device,
                 init_monitor_state(monitor_window, cfg.num_hidden_layers,
                                    device), variant != "standard")


# -- the PINN with monitoring-only sketches -----------------------------------


def make_pinn_step(cfg: MLPConfig, scfg: SketchConfig,
                   opt_cfg: AdamWConfig) -> Callable:
    """step(params, opt, sk, interior, boundary) -> (params, opt, sk,
    loss): exact PINN gradients and AdamW, then, when ``sk`` is a tree,
    the monitor's EMA update of each hidden node on the first N_b rows
    of its activation under the new weights (``ema_triple_update``: one
    ``sketch_update`` launch a node). The sketches never touch the
    weights (the reference's ``benchmarks/bench_pinn.py``)."""
    def step(params, opt, sk, interior, boundary):
        loss, _, grads = value_and_grad(
            lambda p: (pinn_loss(p, cfg, interior, boundary), None), params)
        params, opt = _optimize(params, grads, opt, opt_cfg)
        if sk is not None:
            with torch.no_grad():
                _, acts = mlp_forward(params, interior, cfg)
            hidden, ka = sk.nodes["hidden"], sk.k_active
            new = [ema_triple_update(
                hidden.x[l], hidden.y[l], hidden.z[l],
                acts[l + 1][:scfg.batch_size], sk.proj["upsilon"],
                sk.proj["omega"], sk.proj["phi"], hidden.psi[l], scfg.beta,
                ka) for l in range(cfg.num_hidden_layers)]
            hidden = dataclasses.replace(
                hidden, **{a: torch.stack([t[i] for t in new])
                           for i, a in enumerate("xyz")})
            sk = dataclasses.replace(sk, nodes={"hidden": hidden},
                                     step=sk.step + 1)
        return params, opt, sk, loss

    return step


def train_pinn(cfg: MLPConfig, scfg: SketchConfig, *, steps: int,
               points_fn: Callable, monitor: bool = True, seed: int = 0,
               params=None, sketch: NodeTree | None = None,
               device=None) -> PaperTrainResult:
    """The PINN's loop: ``points_fn(step) -> (interior, boundary)``;
    AdamW with b2 0.999 and no clip. Draws weights, then (with the
    monitor on) its tree, unless given."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = _to(params if params is not None else mlp_init(gen, cfg),
                 device)
    sk = None
    if monitor:
        sk = (tree_to(sketch, device) if sketch is not None
              else init_mlp_sketch(gen, cfg, scfg, "monitor"))
    opt_cfg = AdamWConfig(lr=cfg.learning_rate, b2=0.999, grad_clip=0.0)
    step = make_pinn_step(cfg, scfg, opt_cfg)
    opt = init_adamw(params, opt_cfg)
    history = []
    for s in range(steps):
        interior, boundary = points_fn(s)
        params, opt, sk, loss = step(params, opt, sk, interior.to(device),
                                     boundary.to(device))
        history.append({"step": s, "loss": float(loss)})
    return PaperTrainResult(params=params, history=history, sketch=sk,
                            monitor=None)


def l2_rel_error(params, cfg: MLPConfig, xy: Tensor | None = None, *,
                 n: int = 4096, seed: int = 3) -> float:
    """||u - u_exact|| / ||u_exact|| over ``xy``, or n uniform points of
    [0,1]^2 drawn from ``seed`` on the parameters' device."""
    if xy is None:
        dev = tree_leaves(params)[0].device
        gen = torch.Generator(device=dev).manual_seed(seed)
        xy = torch.rand((n, 2), generator=gen, device=dev)
    with torch.no_grad():
        pred, _ = mlp_forward(params, xy, cfg)
        exact = poisson_exact(xy)
        return float(torch.linalg.vector_norm(pred[:, 0] - exact)
                     / torch.linalg.vector_norm(exact))
