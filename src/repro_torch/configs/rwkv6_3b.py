"""RWKV6-3B (Finch) [arXiv:2404.05892; hf]. Attention-free, data-dep decay.

32L d_model=2560 d_ff=8960 vocab=65536. head_dim 64 => 40 wkv heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65_536,
    mlp_type="rwkv_cm",      # channel-mix (relu^2) in the block itself
    block_pattern=("rwkv",),
    # deviation (DESIGN.md §7): official head_dim is 64 (40 heads); we use
    # 160 (16 heads) so wkv heads align with the 16-way model axis. Param
    # count is identical (projections are DxD); only the recurrent-state
    # granularity changes.
    rwkv_head_dim=160,
    attn_sharding="heads",
))
