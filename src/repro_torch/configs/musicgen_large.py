"""MusicGen-Large [arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048. The EnCodec audio
frontend is a STUB: ``input_specs()`` supplies precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=10_000.0,     # deviation: MusicGen uses sinusoidal PE; we use
                             # RoPE uniformly across the pool (DESIGN.md §7)
    frontend="audio_frames",
    attn_sharding="heads",
))
