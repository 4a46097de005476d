"""Parameter trees as leaf lists and as one flat vector.

A tree is nested dicts (walked in sorted key order, as ``jax.tree``
walks them) and lists of tensors. ``FlatLayout`` lays a tree's tensors
end to end in a given order of leaf paths; the LM passes the order in
which ``ravel_pytree`` lays out the reference's stacked parameters
(``models.transformer.flat_paths``), so a coordinate of the port's flat
gradient is the reference's coordinate of the same weight.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Paths (tuples of keys and list indices) of every tensor of
    ``tree``: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                           prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def tree_leaves(tree) -> list[Tensor]:
    return [get_path(tree, p) for p in leaf_paths(tree)]


def tree_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # a module-level function: a nested one that called itself would be
    # a reference cycle holding ``it``, and so every leaf, until the
    # garbage collector ran (device memory of whole parameter trees)
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [_build(v, it) for v in t]
    return next(it)


def tree_map(fn, tree):
    return tree_like(tree, [fn(t) for t in tree_leaves(tree)])


def get_path(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set_path(tree, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


class FlatLayout:
    """Where each leaf of a tree sits in one flat vector: the leaves at
    ``paths`` (default: ``leaf_paths`` order), end to end, row-major."""

    def __init__(self, template, paths: list[tuple] | None = None):
        self.paths = list(paths if paths is not None
                          else leaf_paths(template))
        if sorted(map(repr, self.paths)) != sorted(
                map(repr, leaf_paths(template))):
            raise ValueError("paths must name every leaf of the tree once")
        self.shapes = [tuple(get_path(template, p).shape)
                       for p in self.paths]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.dim = sum(self.sizes)
        self._template = tree_map(lambda t: None, template)

    def ravel(self, tree, dtype=torch.float32) -> Tensor:
        """A new (dim,) vector of the tree's leaves in layout order."""
        return torch.cat([get_path(tree, p).reshape(-1).to(dtype)
                          for p in self.paths])

    def unravel(self, flat: Tensor):
        """The tree over ``flat``: every leaf is a view into it."""
        views, offset = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            views.append(flat[offset:offset + size].view(shape))
            offset += size
        return self.tree_of(views)

    def tree_of(self, leaves):
        """The tree holding ``leaves``, given in layout order."""
        out = tree_map(lambda t: None, self._template)
        for path, leaf in zip(self.paths, leaves):
            _set_path(out, path, leaf)
        return out

    def leaves(self, tree) -> list[Tensor]:
        """The tree's leaves in layout order."""
        return [get_path(tree, p) for p in self.paths]
