"""internvl2-76b — VLM: the LM backbone of InternViT + InternLM2
(70B-class).

[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. The InternViT tower is out of scope: a training batch may
carry 256 precomputed patch embeddings (B, 256, d_model), which
``models.transformer.forward`` splices over the first positions of the
embedded sequence. Full attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    pattern=("full",),
    mlp_type="swiglu",
    frontend="vision",
    num_frontend_tokens=256,
    sketch_mode="backprop",
)
