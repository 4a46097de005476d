"""gemma3-27b — dense, 5:1 local:global attention interleave.

[hf:google/gemma-3-1b-pt; unverified] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144. Local window 1024; head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
