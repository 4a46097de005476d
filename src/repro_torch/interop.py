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

from repro_torch.sketches import NodeTree, SketchNode


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


def proj_from_jax(proj: dict, device="cpu") -> dict:
    """A dense {"upsilon","omega","phi"} projection dict."""
    return {k: _tensor(v, device) for k, v in proj.items()}


def tree_from_jax(node_tree, device="cpu") -> NodeTree:
    """A reference ``NodeTree`` (paper-kind nodes, dense projections)
    -> the port's. Node stacks keep their layer order; the PRNG key and
    refresh epoch have no counterpart in the port."""
    nodes = {
        name: SketchNode(x=_tensor(n.x, device), y=_tensor(n.y, device),
                         z=_tensor(n.z, device), psi=_tensor(n.psi, device))
        for name, n in node_tree.nodes.items()
    }
    return NodeTree(nodes=nodes, proj=proj_from_jax(node_tree.proj, device),
                    rank=_tensor(node_tree.rank, device).to(torch.int32),
                    step=int(node_tree.step))
