"""StarCoder2-15B [arXiv:2402.19173; hf]. GQA, RoPE, LayerNorm + GELU MLP.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    mlp_type="gelu",
    norm_type="layernorm",
    qkv_bias=True,
    rope_theta=100_000.0,
    attn_sharding="heads",   # 48 % 16 == 0
))
