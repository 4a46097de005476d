"""Config registry: ``get_arch(name)`` / ``ARCHS``.

Every architecture of the JAX package is registered: the dense-attention
ones, xlstm-1.3b (mLSTM and sLSTM blocks), recurrentgemma-2b (RG-LRU and
local attention blocks), the MoE ones (qwen3-moe-30b-a3b, mixtral-8x22b)
and the frontend ones (musicgen-large over audio tokens, internvl2-76b
with spliced patch embeddings; ``models/frontends.py``).
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
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "ARCHS", "get_arch", "reduced"]
