"""Per-layer FLOP/activation profiles for every supported architecture.
The port's copy of ``repro/core/profiles.py`` (host numpy, unchanged).

Two families:
  * CNNs (paper's own VGG19 / ResNet101) — from configs/cnn.py specs.
  * LM decoders (the 10 assigned archs)  — per-block MACs for a serve
    request of S tokens; the split boundary tensor is the (S, d_model)
    residual stream (plus recurrent state for SSM/hybrid, which is what
    makes the technique *cheaper* for those archs — DESIGN.md §4).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.cnn import get_cnn_config
from repro_torch.core.cost_model import (LayerProfile, pad_profile,
                                         profile_from_cnn)


def vgg19_profile() -> LayerProfile:
    return profile_from_cnn(get_cnn_config("vgg19-imagenet-mini"))


def resnet101_profile() -> LayerProfile:
    return profile_from_cnn(get_cnn_config("resnet101-tiny-imagenet"))


def max_split_layers(profiles) -> int:
    """Batch-wide ``L_max`` for a mixed-architecture scenario batch."""
    return max(p.n_layers for p in profiles)


def padded_profiles(profiles):
    """Pad a heterogeneous profile set to a shared ``L_max`` layout.

    Returns ``[(padded profile, valid mask), ...]`` — every profile's
    per-layer arrays become ``(L_max+1,)`` with edge-padded tails and a
    validity mask, so VGG19 and ResNet101 scenarios can stack into one
    dense batch (see ``torch_cost.stack_params``).
    """
    l_max = max_split_layers(profiles)
    return [pad_profile(p, l_max) for p in profiles]


# ---------------------------------------------------------------------------
# LM decoder profiles (split-serving the assigned pool)
# ---------------------------------------------------------------------------


def _block_macs(cfg, kind: str, seq: int) -> float:
    """MACs for one decoder block over a request of `seq` tokens."""
    D, F = cfg.d_model, cfg.d_ff
    hd = cfg.hd
    m = 0.0
    if kind in ("attn", "local", "attn_dense"):
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        m += seq * D * (Hq + 2 * Hkv) * hd          # qkv proj
        m += seq * Hq * hd * D                       # out proj
        win = cfg.window if (kind == "local" or cfg.attn_type == "swa") else 0
        kv_len = min(seq, win) if win else seq
        m += 2 * seq * kv_len * Hq * hd / 2          # causal scores+AV (avg)
        mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        if cfg.moe and kind != "attn_dense":
            # MoE MLP on every routed attention layer ("attn" AND windowed
            # "local"); only the leading first_k_dense layers stay dense
            m += seq * D * cfg.n_experts             # router
            m += seq * (cfg.top_k + cfg.n_shared_experts) * mult * D * F
        else:
            m += seq * mult * D * F
    elif kind == "rglru":
        R = cfg.lru_width or D
        m += seq * (3 * D * R + R * R / 8)           # in/out proj + blk gates
        mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        m += seq * mult * D * F
    elif kind == "rwkv":
        m += seq * 5 * D * D                         # r,k,v,g,o projections
        m += seq * cfg.n_rwkv_heads * cfg.rwkv_head_dim ** 2 * 2  # wkv
        m += seq * 3 * D * F                         # channel mix
    return float(m)


def _boundary_bytes(cfg, l: int, seq: int, bytes_per_elem: int = 2) -> float:
    """Bytes crossing the split after layer l for a decode continuation:
    the (seq, d_model) residual stream plus the per-layer state of every
    device-side layer the server needs to keep decoding — the KV cache
    for attention layers (2 * kv_len * n_kv_heads * head_dim elements,
    window-bounded for swa/local) and the fixed-size f32 recurrent state
    for RG-LRU / RWKV layers. The recurrent state is seq-independent,
    which is what makes SSM/hybrid archs cheap to split."""
    b = seq * cfg.d_model * bytes_per_elem
    kinds = cfg.layer_kinds()[:l]
    for k in kinds:
        if k == "rglru":
            b += (cfg.lru_width or cfg.d_model) * 4
        elif k == "rwkv":
            b += cfg.n_rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
        else:  # attn / local / attn_dense: per-layer KV cache
            win = cfg.window if (k == "local" or cfg.attn_type == "swa") else 0
            kv_len = min(seq, win) if win else seq
            b += 2 * kv_len * cfg.n_kv_heads * cfg.hd * bytes_per_elem
    return float(b)


def lm_profile(cfg, seq: int, batch: int = 1,
               bytes_per_elem: int = 2) -> LayerProfile:
    """LayerProfile over decoder blocks for a `seq`-token request."""
    kinds = cfg.layer_kinds()
    per = np.array([_block_macs(cfg, k, seq) for k in kinds]) * batch
    cum = np.concatenate([[0.0], np.cumsum(per)])
    # unembed (always server-side) counts toward the total pipeline
    total = float(cum[-1] + seq * batch * cfg.d_model * cfg.vocab_size)
    tx = np.array([_boundary_bytes(cfg, l, seq, bytes_per_elem) * batch
                   for l in range(len(kinds) + 1)])
    return LayerProfile(cfg.name, cum, total, tx, len(kinds))
