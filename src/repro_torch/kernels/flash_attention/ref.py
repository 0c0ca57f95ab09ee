"""Plain PyTorch version of the flash-attention kernel: dense causal GQA
softmax attention, with an optional sliding window. Counterpart of
``repro/kernels/flash_attention/ref.py::attention_ref``.

It is what ``ops.flash_attention`` returns for tensors on the CPU, and
what the CUDA kernel is held against on the card. Computed in float32,
masked with -1e30 (not -inf), scale ``1/sqrt(hd)``; the q row at index i
has position i. Output in q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones(Sq, Skv, dtype=torch.bool, device=q.device))
    if window:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)
