"""Carry the JAX package's parameters and sketch state into the port.

Inputs are the reference's pytrees with numpy leaves (the caller maps
``np.asarray`` over them), so this module imports neither ``jax`` nor
``repro``. RNG is not shared between the packages: a differential test
builds weights, projections and sketch trees once on the JAX side and
feeds the same numbers to both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.corange import CorangeProjections
from repro_torch.sketches import NodeTree, PsparseProjections, SketchNode
from repro_torch.sketches.psparse import PsparseCorangeProjections


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference's ``init_params`` pytree -> the port's parameters.

    The reference stacks each pattern position i over the G full
    periods (``groups[i]`` leaves have a leading (G,) axis, layer
    g*P + i) and keeps the remainder layers in ``tail``; the port keeps
    one dict per layer in layer order. Tied configs have no ``head``
    and unembed against the embedding in both packages.
    """
    groups, tail = tree["groups"], tree["tail"]
    P = len(groups)
    G = (np.shape(groups[0]["norm1"]["scale"])[0] if P else 0)
    layers = [None] * (G * P)
    for i, grp in enumerate(groups):
        for g in range(G):
            layers[g * P + i] = _map(grp, lambda a, g=g: _tensor(a[g], device))
    layers += [_map(t, lambda a: _tensor(a, device)) for t in tail]
    return {
        "embed": _map(tree["embed"], lambda a: _tensor(a, device)),
        "final_norm": _map(tree["final_norm"], lambda a: _tensor(a, device)),
        "layers": layers,
    }


def mlp_params_from_jax(params: list, device="cpu") -> list[dict]:
    """The reference's paper-MLP parameters (a list of {"w", "bias"})."""
    return [{k: _tensor(v, device) for k, v in layer.items()}
            for layer in params]


def adamw_state_from_jax(state: dict, device="cpu") -> dict:
    """An ``init_adamw``/``adamw_update`` state: moments shaped like the
    parameters (the paper MLP's list, or the LM's stacked tree, carried
    over as ``params_from_jax`` carries the weights), and the step
    count."""
    conv = params_from_jax if isinstance(state["m"], dict) \
        else mlp_params_from_jax
    return {"m": conv(state["m"], device), "v": conv(state["v"], device),
            "count": _tensor(state["count"], device).to(torch.int32)}


def error_feedback_from_jax(err, device="cpu"):
    """Compression error feedback: countsketch's flat {u, v} (or, from a
    data-parallel run, its per-worker ledgers stacked (W, D) as
    ``checkpoint.checkpointer.gather_per_worker`` stacks them), or
    top-k's tree shaped like the LM parameters."""
    if set(err) == {"u", "v"}:
        return {k: _tensor(v, device) for k, v in err.items()}
    return params_from_jax(err, device)


def sketch_err_from_jax(ledger, device="cpu") -> dict:
    """The int8 sketch wire's per-worker residual ledgers, {node: {"x",
    "y", "z"}} with (W, ...) leaves stacked per worker as
    ``gather_per_worker`` stacks them."""
    return {name: {a: _tensor(ledger[name][a], device) for a in "xyz"}
            for name in sorted(ledger)}


def csvec_params_from_jax(params) -> tuple[tuple[int, ...], ...]:
    """A reference ``CSVec.params`` (4, r) uint32 array -> the port's
    host-integer coefficients."""
    return tuple(tuple(int(c) for c in row)
                 for row in np.asarray(params, dtype=np.uint32))


def psparse_from_jax(params, num_tokens: int, k_max: int, density: float,
                     device="cpu") -> PsparseProjections:
    """Seeds-only projections from the reference's (3, 4) uint32
    coefficients; the port holds them as host integers."""
    rows = tuple(tuple(int(c) for c in row)
                 for row in np.asarray(params, dtype=np.uint32))
    return PsparseProjections(params=rows, num_tokens=int(num_tokens),
                              k_max=int(k_max), density=float(density),
                              device=torch.device(device))


def proj_from_jax(proj, device="cpu"):
    """A dense {"upsilon","omega","phi"} projection dict, the reference's
    ``PsparseProjections`` (any object with ``params``, ``num_tokens``,
    ``k_max`` and ``density``), or a corange tree's projections: dense
    ``CorangeProjections`` (``upsilon``, ``omega``, ``phi``, ``psi``) or
    ``PsparseCorangeProjections`` (``params``, ``d``, ``n_b``, ...)."""
    if hasattr(proj, "n_b"):
        rows = tuple(tuple(int(c) for c in row)
                     for row in np.asarray(proj.params, dtype=np.uint32))
        return PsparseCorangeProjections(
            params=rows, d=int(proj.d), n_b=int(proj.n_b),
            k_max=int(proj.k_max), density=float(proj.density),
            device=torch.device(device))
    if hasattr(proj, "params"):
        return psparse_from_jax(proj.params, proj.num_tokens, proj.k_max,
                                proj.density, device)
    if hasattr(proj, "upsilon"):
        return CorangeProjections(*(_tensor(getattr(proj, n), device)
                                    for n in ("upsilon", "omega", "phi",
                                              "psi")))
    return {k: _tensor(v, device) for k, v in proj.items()}


def tree_from_jax(node_tree, device="cpu") -> NodeTree:
    """A reference ``NodeTree`` of paper- or corange-kind nodes (a node
    without a ``kind`` is a paper one), with dense or psparse
    projections -> the port's. Node stacks keep their layer order; the
    refresh epoch carries over, the PRNG key has no counterpart (the
    port's refreshes draw from its own seed)."""
    nodes = {
        name: SketchNode(x=_tensor(n.x, device), y=_tensor(n.y, device),
                         z=_tensor(n.z, device), psi=_tensor(n.psi, device),
                         kind=getattr(n, "kind", "paper"))
        for name, n in node_tree.nodes.items()
    }
    return NodeTree(nodes=nodes, proj=proj_from_jax(node_tree.proj, device),
                    rank=_tensor(node_tree.rank, device).to(torch.int32),
                    step=int(node_tree.step), epoch=int(node_tree.epoch))
