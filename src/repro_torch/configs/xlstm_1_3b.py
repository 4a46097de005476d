"""xlstm-1.3b — sLSTM + mLSTM recurrent blocks (7:1 m:s ratio).

[arXiv:2405.04517; unverified] 48L d_model=2048 4H d_ff=0 (xLSTM blocks
carry their own up/down projections; no separate FFN) vocab=50304.
Sketched backprop does not apply to the recurrence, so the model
sketches in monitoring mode only.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    mlp_type="none",
    sketch_mode="monitor",
)
