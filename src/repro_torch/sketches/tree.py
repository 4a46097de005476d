"""NodeTree — the node-keyed registry of sketch state (counterpart of
``repro.sketches.tree``).

One NodeTree holds every sketched activation node of a network, keyed by
name, plus what the nodes share: the (T, k_max) batch projections and
the active rank. The rank is a 0-d int32 tensor on the tree's device, so
a rank change alters values and never a shape (static k_max, masked
columns).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sketches.node import SketchNode, init_paper_node

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Registration entry: one sketched activation node (per layer)."""

    width: int                  # feature dim d of the node
    layers: int | None = None   # None = single node, int = per-layer stack


@dataclasses.dataclass
class NodeTree:
    """All sketch state of one network, keyed by node name."""

    nodes: dict[str, SketchNode]
    proj: dict[str, Tensor]     # {"upsilon","omega","phi"}: (T, k_max)
    rank: Tensor                # () int32 — active target rank r
    step: int = 0               # EMA update counter

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
                   num_tokens: int, k_max: int,
                   dtype=torch.float32) -> NodeTree:
    """Zero sketches + fresh Gaussian projections, all at full rank.

    Draws come from ``gen`` in the reference's order (projections, then
    each node's psi in registry order); the bits differ from
    ``jax.random``, so differential tests inject the reference's tree.
    """
    proj = gaussian_projections(gen, num_tokens, k_max, dtype)
    nodes = {name: init_paper_node(gen, spec.width, k_max,
                                   layers=spec.layers, dtype=dtype)
             for name, spec in specs.items()}
    rank = torch.tensor((k_max - 1) // 2, dtype=torch.int32,
                        device=gen.device)
    return NodeTree(nodes=nodes, proj=proj, rank=rank)


def node_paths(tree: NodeTree) -> list[str]:
    """Flat per-layer paths ("res/5", "block3/ffn_in", ...) in the order
    ``core.monitor.tree_metrics`` emits rows: sorted by node name,
    layer-major within a node."""
    out = []
    for name in sorted(tree.nodes):
        stack = tree.nodes[name].x.shape[:-2]
        if not stack:
            out.append(name)
            continue
        for i in range(stack[0]):
            out.append(f"res/{i}" if name == "res" else f"block{i}/{name}")
    return out
