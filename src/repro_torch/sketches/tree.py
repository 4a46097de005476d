"""NodeTree — the node-keyed registry of sketch state (counterpart of
``repro.sketches.tree``).

One NodeTree holds every sketched activation node of a network, keyed by
name, plus what the nodes share: the batch projections (dense (T, k_max)
Gaussian matrices, or seeds-only ``PsparseProjections``) and the active
rank. The rank is a 0-d int32 tensor on the tree's device, so a rank
change alters values and never a shape (static k_max, masked columns).
A refresh (``refresh_tree``) draws new projections and psi from a
generator derived from the tree's ``seed`` and refresh ``epoch``, as the
reference folds its key with the epoch; the bits differ from
``jax.random``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import torch

from repro_torch.core.sketch import validate_proj_kind
from repro_torch.sketches.node import (
    SketchNode, init_paper_node, zero_node_sketches,
)
from repro_torch.sketches.psparse import (
    init_psparse_projections, is_psparse, refresh_psparse_projections,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Registration entry: one sketched activation node (per layer)."""

    width: int                  # feature dim d of the node
    # None = single node, int = per-layer stack, tuple = a stack of more
    # dims: (num_layers, num_experts) gives (L, E, d, k) triples and
    # (L, E, k) psi
    layers: int | tuple[int, ...] | None = None


@dataclasses.dataclass
class NodeTree:
    """All sketch state of one network, keyed by node name."""

    nodes: dict[str, SketchNode]
    proj: Any                   # {"upsilon","omega","phi"}: (T, k_max),
    #                             PsparseProjections, or a corange
    #                             tree's CorangeProjections or
    #                             PsparseCorangeProjections
    rank: Tensor                # () int32 — active target rank r
    step: int = 0               # EMA update counter
    epoch: int = 0              # projection refreshes so far
    seed: int = 0               # refresh generators derive from it

    @property
    def k_active(self) -> Tensor:
        return 2 * self.rank + 1


def gaussian_projections(gen: torch.Generator, num_tokens: int,
                         k_max: int, dtype=torch.float32) -> dict:
    """Dense N(0, 1) (num_tokens, k_max) upsilon/omega/phi."""
    return {name: torch.randn((num_tokens, k_max), generator=gen,
                              device=gen.device).to(dtype)
            for name in ("upsilon", "omega", "phi")}


def init_node_tree(gen: torch.Generator, specs: dict[str, NodeSpec],
                   num_tokens: int, k_max: int, dtype=torch.float32,
                   proj_kind: str = "gaussian",
                   proj_density: float = 0.1) -> NodeTree:
    """Zero sketches + fresh projections, all at full rank.

    Draws come from ``gen`` in the reference's order (projections, then
    each node's psi in registry order); the bits differ from
    ``jax.random``, so differential tests inject the reference's tree.
    The tree's refresh seed is ``gen.initial_seed()``.
    """
    validate_proj_kind(proj_kind)
    if proj_kind == "psparse":
        proj = init_psparse_projections(gen, num_tokens, k_max,
                                        proj_density)
    else:
        proj = gaussian_projections(gen, num_tokens, k_max, dtype)
    nodes = {name: init_paper_node(gen, spec.width, k_max,
                                   layers=spec.layers, dtype=dtype)
             for name, spec in specs.items()}
    rank = torch.tensor((k_max - 1) // 2, dtype=torch.int32,
                        device=gen.device)
    return NodeTree(nodes=nodes, proj=proj, rank=rank,
                    seed=gen.initial_seed())


def zero_sketches(tree: NodeTree) -> NodeTree:
    """Zero every node's x/y/z (psi, projections, counters untouched)."""
    return dataclasses.replace(
        tree, nodes={n: zero_node_sketches(v) for n, v in tree.nodes.items()})


def refresh_tree(tree: NodeTree) -> NodeTree:
    """New projections and psi, zero sketches: the paper's "reinitialize
    matrices" after a rank change (Alg. 1). Shapes never change; the
    epoch advances and the step counter restarts. Draws: projections,
    then each node's psi in sorted node order."""
    epoch = tree.epoch + 1
    gen = torch.Generator(device=tree.rank.device)
    gen.manual_seed((tree.seed * 1_000_003 + epoch) % 2**63)
    if is_psparse(tree.proj):
        proj = refresh_psparse_projections(tree.proj, gen)
    else:
        fresh = [torch.randn(p.shape, generator=gen, device=p.device,
                             dtype=p.dtype) for p in _proj_tensors(tree.proj)]
        proj = (dict(zip(tree.proj, fresh)) if isinstance(tree.proj, dict)
                else type(tree.proj)(*fresh))
    nodes = {}
    for name in sorted(tree.nodes):
        node = zero_node_sketches(tree.nodes[name])
        if node.psi.numel():
            node = dataclasses.replace(node, psi=torch.randn(
                node.psi.shape, generator=gen, device=node.psi.device,
                dtype=node.psi.dtype))
        nodes[name] = node
    return dataclasses.replace(tree, nodes=nodes, proj=proj, epoch=epoch,
                               step=0)


def _proj_tensors(proj) -> list[Tensor]:
    """The tensors of a dense projection: a {"upsilon","omega","phi"}
    dict or a ``core.corange.CorangeProjections``."""
    if isinstance(proj, dict):
        return list(proj.values())
    return [getattr(proj, f.name) for f in dataclasses.fields(proj)]


def tree_memory_bytes(tree: NodeTree) -> int:
    """Bytes held by the tree: sketches, psi and projections (a psparse
    tree's are its uint32 coefficients)."""
    total = sum(t.numel() * t.element_size()
                for n in tree.nodes.values() for t in (n.x, n.y, n.z, n.psi))
    if is_psparse(tree.proj):
        return total + 4 * sum(len(row) for row in tree.proj.params)
    return total + sum(p.numel() * p.element_size()
                       for p in _proj_tensors(tree.proj))


def proj_to(proj, device):
    """A copy of a projection (dense dict, corange or psparse) on
    ``device``."""
    if isinstance(proj, dict):
        return {n: v.detach().to(device=device, copy=True)
                for n, v in proj.items()}
    return proj.to(device)


def tree_to(tree: NodeTree, device) -> NodeTree:
    """A copy of ``tree`` with every tensor on ``device``."""
    def mv(t):
        return t.detach().to(device=device, copy=True)
    return dataclasses.replace(
        tree, nodes={n: dataclasses.replace(v, x=mv(v.x), y=mv(v.y),
                                            z=mv(v.z), psi=mv(v.psi))
                     for n, v in tree.nodes.items()},
        proj=proj_to(tree.proj, device), rank=mv(tree.rank))


def node_paths(tree: NodeTree) -> list[str]:
    """Flat per-layer paths ("res/5", "block3/ffn_in", ...) in the order
    ``core.monitor.tree_metrics`` emits rows: sorted by node name,
    layer-major within a node; a stack of more dims appends its other
    indices ("block3/expert_in/7")."""
    out = []
    for name in sorted(tree.nodes):
        stack = tree.nodes[name].x.shape[:-2]
        if not stack:
            out.append(name)
            continue
        for idx in itertools.product(*(range(s) for s in stack)):
            base = f"res/{idx[0]}" if name == "res" else \
                f"block{idx[0]}/{name}"
            out.append("/".join([base, *map(str, idx[1:])]))
    return out
