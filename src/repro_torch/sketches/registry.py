"""Arch-keyed NodeSpec registry (counterpart of
``repro.sketches.registry``).

Model modules call ``register_node_specs(family, fn)`` at import and
every consumer (``models.transformer.init_lm_sketch_state``,
``train.step``, ``train.paper_trainer``) resolves its specs through
``node_specs_for(cfg)``. A new sketched architecture is one
registration and a spec function; the dispatch below stays as it is.

Family resolution:

* ``repro_torch.configs.base.ArchConfig`` -> "moe" when ``cfg.is_moe``,
  else "recurrent" when its pattern holds a recurrent kind (mlstm,
  slstm, rglru), else "lm". The three share the transformer's spec
  function, which emits each family's nodes.
* ``repro_torch.configs.paper.MLPConfig`` -> "mlp".
* ``repro_torch.configs.paper.ConvConfig`` -> "conv".

``node_specs_for(cfg, **kw)`` passes keyword arguments on to the
registered spec function.
"""
from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., dict]] = {}

#: recurrent layer kinds whose scan carries get sketch nodes
RECURRENT_KINDS = ("mlstm", "slstm", "rglru")


def register_node_specs(family: str, fn: Callable[..., dict]) -> None:
    """Register ``fn(cfg, **kw) -> {name: NodeSpec}`` for ``family``.
    A later registration replaces an earlier one."""
    if not isinstance(family, str) or not family:
        raise ValueError(f"family must be a non-empty str, got {family!r}")
    _REGISTRY[family] = fn


def registered_families() -> tuple:
    return tuple(sorted(_REGISTRY))


def family_for(cfg: Any) -> str:
    """The spec family of a config object."""
    from repro_torch.configs.base import ArchConfig

    if isinstance(cfg, ArchConfig):
        if cfg.is_moe:
            return "moe"
        if set(cfg.pattern) & set(RECURRENT_KINDS):
            return "recurrent"
        return "lm"
    name = type(cfg).__name__
    if name == "MLPConfig":
        return "mlp"
    if name == "ConvConfig":
        return "conv"
    raise TypeError(
        f"no NodeSpec family for config type {type(cfg).__name__}; "
        f"register one with register_node_specs(...)")


def node_specs_for(cfg: Any, **kw) -> dict:
    """The {name: NodeSpec} of any registered config."""
    family = family_for(cfg)
    if family not in _REGISTRY:
        # the model modules register at import
        import repro_torch.models.mlp  # noqa: F401  (mlp, conv)
        import repro_torch.models.transformer  # noqa: F401  (lm, moe, ...)
    try:
        fn = _REGISTRY[family]
    except KeyError:
        raise KeyError(
            f"NodeSpec family {family!r} has no registered spec "
            f"function; known families: {registered_families()}")
    return fn(cfg, **kw)
