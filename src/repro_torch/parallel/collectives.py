"""The data-parallel step's collectives over W workers held in one
process (counterpart of ``repro.parallel.collectives``).

A worker's value is a row of a stacked (W, ...) tensor or an entry of a
list of W tensors. A psum is the ordered left fold ``x[0] + x[1] + ... +
x[W-1]``, the order in which XLA:CPU's psum sums, so the port's merges
are the reference's bit for bit where the values are.

Every collective reports ``{"name", "bytes", "kind"}`` (the bytes one
worker puts on the wire) to the recorders that ``collective_trace``
opens, as the reference's trace-time accounting does; the tests hold the
records against the reference's ``collective_plan``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels.ring_allreduce import ring_allreduce, ring_wire_bytes
from repro_torch.optim.flat import tree_leaves
from repro_torch.sketches.wire import (
    pack_segments, segment_spec, unpack_segments,
)

Tensor = torch.Tensor

_TRACE_LOG: list[list] = []          # stack of active recorders


@contextlib.contextmanager
def collective_trace():
    """Record every collective issued by the helpers in this module
    while the context is open: yields a list of ``{"name", "bytes",
    "kind"}`` dicts, one per collective call."""
    log: list = []
    _TRACE_LOG.append(log)
    try:
        yield log
    finally:
        _TRACE_LOG.pop()


def _record(name: str, nbytes: int, kind: str = "all_reduce") -> None:
    for log in _TRACE_LOG:
        log.append({"name": name, "bytes": int(nbytes), "kind": kind})


def fold(xs) -> Tensor:
    """``xs[0] + xs[1] + ... + xs[W-1]``, a new tensor."""
    out = xs[0].clone()
    for x in xs[1:]:
        out += x
    return out


def traced_psum(xs, *, name: str) -> Tensor:
    """The psum of the workers' ``xs`` (a list, or a stacked tensor's
    rows), recorded with one worker's bytes."""
    _record(name, xs[0].numel() * xs[0].element_size())
    return fold(xs)


def psum_csvec(sketches: list):
    """Merge the workers' count sketches (exact: sketches are linear).
    Workers share the hash family, which is never reduced."""
    return dataclasses.replace(sketches[0], table=traced_psum(
        [cs.table for cs in sketches], name="csvec_table"))


def psum_flat_segments(trees, *, name: str = "flat_segments",
                       barrier: bool = False, ring: str | None = None,
                       ring_workers: int | None = None,
                       ring_exempt: tuple = ()):
    """Sum the workers' trees (a list, or a generator yielding worker
    0's first) through ONE collective: each tree is packed into a flat
    f32 row, the rows are merged and the sum unpacked into a tree of
    views. A generator's tree is packed, and may be dropped, before the
    next is made.

    ``ring=None`` folds the rows (the psum). ``ring="fp32"`` sends the
    (W, total) rows through the ring kernel instead, bit for bit the
    fold. ``ring="int8"`` carries the top-level segments not named in
    ``ring_exempt`` through the quantising ring and the exempt ones on a
    small f32 psum (recorded as ``name + "_exempt"``), and returns
    ``(merged, residual)`` with ``residual`` a tree of (W, ...) leaves,
    each worker's requantisation ledger. ``ring_workers`` (W) is required
    for any ring. ``barrier`` is accepted for the reference's signature:
    it pins the collective's place in a compiled program, and eager
    PyTorch issues it where it stands.
    """
    del barrier
    if ring is None:
        merged = None
        for tree in trees:
            if merged is None:
                spec = segment_spec(tree)
                merged = pack_segments(tree)
            else:
                merged += pack_segments(tree)
        _record(name, spec.total * 4)
        return unpack_segments(spec, merged)
    if ring_workers is None:
        raise ValueError("ring routing requires ring_workers")
    if ring not in ("fp32", "int8"):
        raise ValueError(f"unknown ring wire {ring!r}")
    if ring == "fp32":
        ring_exempt = ()
    buf = exempt = exempt_spec = None
    w = -1
    for w, tree in enumerate(trees):
        ringed = {k: v for k, v in tree.items() if k not in ring_exempt}
        if buf is None:
            spec = segment_spec(ringed)
            buf = torch.empty((ring_workers, spec.total),
                              dtype=torch.float32,
                              device=tree_leaves(ringed)[0].device)
        pack_segments(ringed, out=buf[w])
        rest = {k: v for k, v in tree.items() if k in ring_exempt}
        if rest:
            if exempt is None:
                exempt_spec, exempt = segment_spec(rest), pack_segments(rest)
            else:
                exempt += pack_segments(rest)
    if w + 1 != ring_workers:
        raise ValueError(f"{w + 1} worker buffers for a {ring_workers}"
                         f"-worker ring")
    _record(name, ring_wire_bytes(spec.total, ring_workers, ring),
            kind="ring")
    y, res = ring_allreduce(buf, ring)
    del buf
    merged = unpack_segments(spec, y)
    if ring == "fp32":
        return merged
    if exempt is not None:
        _record(name + "_exempt", exempt_spec.total * 4)
        merged = {**merged, **unpack_segments(exempt_spec, exempt)}
    return merged, unpack_segments(spec, res)
