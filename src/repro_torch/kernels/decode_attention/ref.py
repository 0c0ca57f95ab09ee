"""Plain PyTorch version of the decode-attention kernel: one query token
per (batch row, q head) against a ring-buffer KV cache. Counterpart of
``repro/kernels/decode_attention/ref.py::decode_attention_ref``.

It is what ``ops.decode_attention`` returns for tensors on the CPU, and
what the CUDA kernel is held against on the card. A slot counts when
``kv_pos <= q_pos`` (and ``q_pos - kv_pos < window`` when a window is
set); ``INT32_MAX`` marks an empty slot. The masks are computed on the
integer positions in int64, never in float. Scores in float32, masked
with -1e30, scale ``1/sqrt(hd)``; output in q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def decode_attention_ref(q, k, v, kv_pos, q_pos, window: int = 0):
    """q (B,Hq,hd); k, v (B,T,Hkv,hd); kv_pos (B,T); q_pos (B,) ->
    (B,Hq,hd)."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    s = s / math.sqrt(hd)
    kp = kv_pos.long()[:, None, None, :]
    qp = q_pos.long()[:, None, None, None]
    mask = kp <= qp
    if window:
        mask = mask & (qp - kp < window)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgt,bthd->bhgd", p / p.sum(-1, keepdim=True),
                     v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)
