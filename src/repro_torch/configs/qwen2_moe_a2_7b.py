"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=151936,
MoE 60 routed top-4 + 4 shared experts. QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    mlp_type="swiglu",
    qkv_bias=True,
    moe=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    rope_theta=1_000_000.0,
    attn_sharding="heads",   # 16 % 16 == 0
    moe_sharding="tensor",   # 60 % 16 != 0 -> shard every expert's d_ff
))
