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


LOG2E = 1.4426950408889634


def attention_tiled_ref(q, k, v, causal: bool = True, window: int = 0,
                        p_dtype=torch.bfloat16):
    """The bfloat16 kernel's arithmetic, step by step, in plain PyTorch:
    64-row q tiles; key tiles of 64 rows (32 above hd 128) from the first
    that some row of the q tile may attend to, tiles wholly masked never
    seen; scores scaled in float32 with log2(e) folded in, masked with
    -1e30; an online softmax in exp2; and P rounded to ``p_dtype`` before
    P V, the one rounding the plain version does not have. Used by the
    tests and the card check, never by the model. Output in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = 64, (32 if hd > 128 else 64)
    scale = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    qf = q.reshape(B, Sq, Hkv, G, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, Sq, Hkv, G, hd, device=q.device)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        kv_end = min(Skv, q1) if causal else Skv
        kv_begin = max(0, q0 - window + 1) if window else 0
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, G, q1 - q0, hd, device=q.device)
        for k0 in range(kv_begin // bk * bk, kv_end, bk):
            k1 = min(k0 + bk, Skv)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            mask = (cols <= rows if causal
                    else torch.ones_like(cols <= rows))
            if window:
                mask = mask & (rows - cols < window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), vf[:, k0:k1])
            m = m_new
        den = torch.where(l == 0, torch.ones_like(l), l)
        out[:, q0:q1] = (acc / den[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
