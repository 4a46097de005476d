"""SketchNode — the per-node unit of sketch state (counterpart of
``repro.sketches.node``).

One node is one monitored activation tensor: its EMA triple (x, y, z),
its interaction weights ``psi`` and the kind of triple it holds. A node
may carry leading stack dims (one entry per layer), as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

KINDS = ("paper", "corange")


@dataclasses.dataclass
class SketchNode:
    """EMA triple + psi for one activation node (possibly stacked).

    kind "paper":   x/y/z (..., d, k_max), psi (..., k_max)
    kind "corange": x (..., k_max, N_b), y (..., d, k_max),
                    z (..., s_max, s_max), psi (..., 0): the core
                    weights live in the tree's projections.
    """

    x: Tensor
    y: Tensor
    z: Tensor
    psi: Tensor
    kind: str = "paper"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"SketchNode.kind must be one of {KINDS}, got "
                             f"{self.kind!r}")

    @property
    def k_max(self) -> int:
        return self.y.shape[-1]

    @property
    def width(self) -> int:
        return self.y.shape[-2]


def init_paper_node(gen: torch.Generator, width: int, k_max: int,
                    layers: int | tuple[int, ...] | None = None,
                    dtype=torch.float32) -> SketchNode:
    """Zero triple + fresh N(0, 1) psi on the generator's device.
    ``layers`` may be a tuple: (L, E) gives (L, E, d, k) triples and
    (L, E, k) psi (the per-expert nodes)."""
    if layers is None:
        lead = ()
    elif isinstance(layers, tuple):
        lead = tuple(int(s) for s in layers)
    else:
        lead = (int(layers),)
    shape = lead + (width, k_max)
    dev = gen.device
    return SketchNode(
        x=torch.zeros(shape, dtype=dtype, device=dev),
        y=torch.zeros(shape, dtype=dtype, device=dev),
        z=torch.zeros(shape, dtype=dtype, device=dev),
        psi=torch.randn(lead + (k_max,), generator=gen, device=dev).to(dtype),
    )


def zero_node_sketches(node: SketchNode) -> SketchNode:
    """Zero x/y/z (rank change / projection refresh); psi untouched."""
    return dataclasses.replace(node, x=torch.zeros_like(node.x),
                               y=torch.zeros_like(node.y),
                               z=torch.zeros_like(node.z))
