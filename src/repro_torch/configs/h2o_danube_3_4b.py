"""H2O-Danube3-4B [arXiv:2401.16818; unverified]. Llama+Mistral mix, SWA.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding window.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,            # 3840 / 32
    d_ff=10240,
    vocab_size=32_000,
    mlp_type="swiglu",
    attn_type="swa",
    window=4096,             # Mistral-style sliding window => sub-quadratic
    rope_theta=100_000.0,
    attn_sharding="heads",
))
