"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32 -> MHA) d_ff=8192
vocab=2048. The EnCodec codec is out of scope: the tokens ARE the
EnCodec codes (vocab 2048) and the frontend is the identity on the
token stream. GELU MLP (T5-style MusicGen decoder), full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=("full",),
    mlp_type="gelu",
    frontend="audio",
    sketch_mode="backprop",
)
