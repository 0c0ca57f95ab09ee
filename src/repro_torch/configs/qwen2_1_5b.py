"""Qwen2-1.5B [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. GQA, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    # 12 heads do not divide the 16-way model axis -> ring/sequence-sharded
    # attention (DESIGN.md §5).
    attn_sharding="sequence",
))
