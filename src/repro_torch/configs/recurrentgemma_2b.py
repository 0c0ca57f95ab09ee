"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf]. RG-LRU + local attn 1:2.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; pattern
(rglru, rglru, local-attn), window 2048, lru_width 2560.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_type="geglu",
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=2560,
    conv1d_width=4,
    rope_theta=10_000.0,
    # 10 heads don't divide 16; local attention is window-bounded (~2% of
    # FLOPs) so it runs replicated over the model axis; LRU/MLP shard on
    # channels (DESIGN.md §5).
    attn_sharding="replicated",
))
