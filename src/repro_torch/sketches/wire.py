"""Flat-segment wire format of the data-parallel step (counterpart of
``repro.sketches.wire``).

Every per-step cross-worker quantity (each sketch node's EMA increments,
the count-sketch table or the dense gradients, the scalar metrics and a
constant-1 worker counter) is laid end to end into one flat f32 buffer a
worker and merged by one collective. The layout is a function of the
tree's shapes alone.

The order is the reference's: ``jax.tree.leaves`` order, dict keys
sorted at every level and lists in order (``optim.flat.leaf_paths``
walks trees so), so the fused buffer runs ``cs_table``/``grads``, ``n``,
``scalars``, ``sketch``. The int8 ring quantises per chunk of the packed
buffer, so another order would change its scales even with every value
right. The step passes the gradients as the list of the port's leaves
in the reference's ravel order (``models.transformer.flat_paths``),
whose concatenation is the reference's stacked leaves'.

An all-reduce sums element-wise, so ``unpack(merge(pack(trees)))`` is
bit for bit one merge per leaf: packing changes how many collectives
carry the values, never their order of summation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.optim.flat import get_path, leaf_paths, tree_like, tree_map

Tensor = torch.Tensor

WIRE_DTYPE = torch.float32
# segment keys the overlap schedule lifts into the early sub-buffer: the
# quantities whose merged values the backward consumes
OVERLAP_EARLY_KEYS = ("sketch",)


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Layout of one packed buffer: per leaf (``leaf_paths`` order) its
    shape, dtype and offset; ``total`` elements in all."""

    template: Any                     # the tree with None leaves
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    total: int

    @property
    def num_segments(self) -> int:
        return len(self.shapes)

    @property
    def wire_bytes(self) -> int:
        """Bytes one worker puts on the all-reduce wire per step."""
        return self.total * torch.finfo(WIRE_DTYPE).bits // 8


def segment_spec(tree) -> SegmentSpec:
    """The flat-segment layout of a tree of tensors."""
    leaves = [get_path(tree, p) for p in leaf_paths(tree)]
    shapes = tuple(tuple(t.shape) for t in leaves)
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += math.prod(s)
    return SegmentSpec(template=tree_map(lambda t: None, tree), shapes=shapes, dtypes=tuple(t.dtype for t in leaves),
                       offsets=tuple(offsets), total=off)


def pack_segments(tree, out: Tensor | None = None) -> Tensor:
    """Every leaf widened to f32 and laid end to end: a new (total,)
    buffer, or written into ``out``."""
    leaves = [get_path(tree, p) for p in leaf_paths(tree)]
    if out is None:
        if not leaves:
            return torch.zeros((0,), dtype=WIRE_DTYPE)
        return torch.cat([t.reshape(-1).to(WIRE_DTYPE) for t in leaves])
    off = 0
    for t in leaves:
        n = t.numel()
        out[off:off + n].copy_(t.reshape(-1))
        off += n
    if off != out.numel():
        raise ValueError(f"packed {off} elements into a buffer of "
                         f"{out.numel()}")
    return out


def unpack_segments(spec: SegmentSpec, flat: Tensor):
    """Inverse of ``pack_segments``: each leaf a view of ``flat`` (...,
    total) at its offset, shaped (..., *shape), cast back to its dtype
    (a view when it is f32). Leading axes carry through, so a (W, total)
    stack of worker buffers unpacks into (W, ...) leaves."""
    if flat.shape[-1] != spec.total:
        raise ValueError(f"packed buffer has shape {tuple(flat.shape)}, the "
                         f"spec expects (..., {spec.total})")
    lead = tuple(flat.shape[:-1])
    leaves = [flat[..., off:off + math.prod(shape)].reshape(lead + shape)
              .to(dtype)
              for shape, dtype, off in zip(spec.shapes, spec.dtypes,
                                           spec.offsets)]
    return tree_like(spec.template, leaves)


def partition_segments(segments: dict, early_keys=OVERLAP_EARLY_KEYS):
    """Split a fused-step segment dict into the overlap schedule's
    (early, late) sub-buffers: early the segments whose merged values
    the backward consumes, late the rest."""
    early = {k: v for k, v in segments.items() if k in early_keys}
    late = {k: v for k, v in segments.items() if k not in early_keys}
    return early, late


def fake_quantize_tree(tree) -> tuple[Any, Any]:
    """The simulated int8 wire, per leaf: ``(dhat, residual)`` trees with
    ``dhat + residual == leaf`` to one rounding, each trailing-axis row
    quantised against its own amax / 127. ``dhat`` crosses the wire;
    ``residual`` stays with the worker. The arithmetic is the reference's
    as its jitted step computes it (XLA:CPU rewrites the source): the
    scale is amax * fl(1/127) and the residual fma(-q, scale, leaf), as
    in the ring kernel (``kernels.ring_allreduce.quant_rows``)."""
    from repro_torch.kernels.ring_allreduce import fma_f32, quant_rows

    dhat, res = [], []
    for p in leaf_paths(tree):
        leaf = get_path(tree, p).to(torch.float32)
        q, scale = quant_rows(leaf)
        dhat.append(q * scale)
        res.append(fma_f32(-q, scale, leaf))
    return tree_like(tree, dhat), tree_like(tree, res)


def int8_segment_bytes(spec: SegmentSpec) -> int:
    """int8 wire cost of one packed buffer: a byte an element and one f32
    scale a trailing-axis row of every leaf."""
    total = 0
    for shape in spec.shapes:
        rows = math.prod(shape[:-1]) if shape else 1
        total += math.prod(shape) + rows * 4
    return total


def tree_increment_leaves(tree) -> dict:
    """The cross-worker leaves of a NodeTree: each node's (x, y, z), by
    sorted node name (psi, projections and counters are replicated)."""
    return {name: {"x": tree.nodes[name].x, "y": tree.nodes[name].y,
                   "z": tree.nodes[name].z}
            for name in sorted(tree.nodes)}


def tree_wire_spec(tree) -> SegmentSpec:
    """Segment layout of a NodeTree's increment leaves."""
    return segment_spec(tree_increment_leaves(tree))
