"""recurrentgemma-2b — hybrid RG-LRU + local attention, pattern (LRU,LRU,attn).

[arXiv:2402.19427; hf] 26L d_model=2560 10H (kv=1 MQA) d_ff=7680
vocab=256000. lru_width=2560, local window 2048, GeGLU MLP (approximated
by swiglu — same FLOP/byte structure). 26 layers are eight (rglru,
rglru, local) periods and an (rglru, rglru) tail. The FFN linears get
sketched backprop; each RG-LRU layer's end-of-sequence state feeds the
"rglru_h" carry node.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window_size=2048,
    lru_width=2560,
    mlp_type="swiglu",
    tie_embeddings=True,
    sketch_mode="backprop",
)
