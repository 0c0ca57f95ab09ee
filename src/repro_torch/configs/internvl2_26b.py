"""InternVL2-26B [arXiv:2404.16821; hf]. InternViT + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The InternViT patch
frontend is a STUB: ``input_specs()`` supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    attn_sharding="heads",   # 48 % 16 == 0; kv=8 replicated within groups
))
