"""granite-34b — deep dense code model, MQA (kv=1).

[arXiv:2405.04324; hf] 88L d_model=6144 48H (kv=1 MQA) d_ff=24576
vocab=49152. GPT-BigCode-style GELU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=("full",),
    mlp_type="gelu",
)
