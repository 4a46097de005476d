"""Config registry: ``get_arch(name)`` / ``ARCHS``.

Only the architectures whose blocks the port runs are registered: the
dense-attention ones, xlstm-1.3b (mLSTM and sLSTM blocks),
recurrentgemma-2b (RG-LRU and local attention blocks) and the MoE ones
(qwen3-moe-30b-a3b, mixtral-8x22b). The frontend archs exist in the JAX
package and raise here until their frontends are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduced

_ARCH_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
}

# Architectures of the JAX package that need frontends the port does
# not have yet, with the ROADMAP item that ports them.
_NOT_PORTED = {
    "musicgen-large": "ROADMAP A13 (models/frontends.py)",
    "internvl2-76b": "ROADMAP A13 (models/frontends.py)",
}

ARCHS = tuple(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: "
            f"{_NOT_PORTED[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "ARCHS", "get_arch", "reduced"]
