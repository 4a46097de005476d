"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768. SWA window 4096. Sketched backprop on the attention
out-projection; the expert FFNs are monitored ("expert_in"), as routed
sub-batches break the fixed batch projection of the sketched backward.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=("swa",),
    window_size=4096,
    num_experts=8,
    experts_per_token=2,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    sketch_mode="backprop",
)
