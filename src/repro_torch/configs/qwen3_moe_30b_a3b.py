"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936. Sketched backprop on the attention out-projection
("attn_o"); the experts' dispatched inputs feed monitoring-only
"expert_in" nodes, one (E, d, k) stack a layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=("full",),
    num_experts=128,
    experts_per_token=8,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    sketch_mode="backprop",
)
