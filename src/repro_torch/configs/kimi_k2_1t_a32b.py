"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
MoE 384 routed experts top-8 (+1 shared, first layer dense).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,           # 7168 / 64
    d_ff=2048,              # per-expert hidden
    vocab_size=163_840,
    mlp_type="swiglu",
    moe=True,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    first_k_dense=1,
    rope_theta=50_000.0,
    attn_sharding="heads",   # 64 % 16 == 0; kv=8 replicated within groups
    moe_sharding="expert",   # 384 % 16 == 0 -> EP on the model axis
))
