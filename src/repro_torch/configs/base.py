"""Architecture configuration (counterpart of ``repro.configs.base``).

Every architecture is a frozen ``ArchConfig``; ``reduced`` shrinks one to
a CPU-testable size while keeping its block pattern. Dtypes are torch
dtypes: parameters are stored in ``param_dtype`` and the forward computes
in ``dtype``.
"""
from __future__ import annotations

import dataclasses

import torch

# Block types a decoder stack may contain. Each entry of `pattern` is one
# of these; the pattern tiles up to num_layers (remainder = tail).
BLOCK_TYPES = ("full", "swa", "local", "global", "mlstm", "slstm", "rglru")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (public-literature config)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                        # dense FFN width (expert width for MoE)
    vocab_size: int
    pattern: tuple[str, ...] = ("full",)
    head_dim: int = 0                # 0 -> d_model // num_heads
    window_size: int = 4096          # for swa/local blocks
    # MoE: experts, top-k routing, slots an expert per routed token
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # modality frontend: "audio" is the identity on the token stream,
    # "vision" splices num_frontend_tokens patch embeddings over the
    # first positions (models/frontends.py)
    frontend: str = "none"           # none | audio | vision
    num_frontend_tokens: int = 0
    mlp_type: str = "swiglu"         # swiglu | gelu | none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # recurrent blocks
    conv_width: int = 4              # temporal conv width in recurrent blocks
    lru_width: int = 0               # RG-LRU state width; 0 -> d_model
    # paper technique in training: sketched backprop on the dense FFN
    # ("backprop"), monitoring-only residual nodes ("monitor"), or none
    sketch_mode: str = "backprop"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        for p in self.pattern:
            if p not in BLOCK_TYPES:
                raise ValueError(f"unknown block type {p!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def layer_types(self) -> tuple[str, ...]:
        """Per-layer block type, pattern tiled to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    @property
    def num_groups(self) -> int:
        """Full pattern periods that fit in num_layers."""
        return self.num_layers // len(self.pattern)

    @property
    def tail_types(self) -> tuple[str, ...]:
        """Remainder layers after the full pattern periods."""
        return self.pattern[: self.num_layers % len(self.pattern)]


def reduced(arch: ArchConfig, *, layers_per_pattern: int = 1) -> ArchConfig:
    """Shrink to a CPU-testable config preserving the block pattern
    (the same cut as ``repro.configs.base.reduced``)."""
    n_layers = max(len(arch.pattern) * layers_per_pattern, 2)
    n_kv = max(1, min(arch.num_kv_heads, 2))
    n_q = max(n_kv, 4)
    return dataclasses.replace(
        arch,
        name=arch.name + "-reduced",
        num_layers=n_layers,
        d_model=64,
        num_heads=n_q,
        num_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if arch.d_ff == 0 else 128,
        vocab_size=256,
        window_size=min(arch.window_size, 32),
        num_experts=min(arch.num_experts, 4) if arch.is_moe else 0,
        experts_per_token=min(arch.experts_per_token, 2) if arch.is_moe else 0,
        num_frontend_tokens=min(arch.num_frontend_tokens, 4),
        lru_width=0,
        dtype=torch.float32,
        param_dtype=torch.float32,
    )
