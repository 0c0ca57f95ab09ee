"""DeepSeek-LLM-7B [arXiv:2401.02954; hf]. Llama-arch.

30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    attn_sharding="heads",
))
