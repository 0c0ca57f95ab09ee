"""Plain PyTorch version of the flash-attention kernels: dense causal GQA
softmax attention, with an optional sliding window. Counterpart of
``repro/kernels/flash_attention/ref.py::attention_ref``.

``attention_ref`` is what ``ops.flash_attention`` returns for tensors on
the CPU, and what the CUDA kernel is held against on the card. Computed
in float32, masked with -1e30 (not -inf), scale ``1/sqrt(hd)``; the q
row at index i has position i. Output in q's dtype.
``attention_lse_ref`` is the forward's second output, each row's
log-sum-exp in base 2, and ``attention_bwd_ref`` the backward: autograd
through ``attention_ref``. ``attention_tiled_ref`` and
``attention_bwd_tiled_ref`` repeat the kernels' own arithmetic step by
step, for the tests and the card check only.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(Sq, Skv, causal, window, device, q0=0, k0=0):
    """Allowed (q, k) pairs of rows q0.. and keys k0.. as bool (Sq, Skv)."""
    qpos = torch.arange(q0, q0 + Sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + Skv, device=device)[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones(Sq, Skv, dtype=torch.bool, device=device))
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def _scores(q, k, causal, window):
    """Masked scores (B,Hkv,G,Sq,Skv) in float32, scale 1/sqrt(hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Sq, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(hd)
    return s.masked_fill(~_mask(Sq, Skv, causal, window, q.device), NEG_INF)


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd)."""
    B, Sq, Hq, hd = q.shape
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
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


def attention_lse_ref(q, k, causal: bool = True, window: int = 0):
    """Each row's log-sum-exp of the masked scores, in base 2 (the
    scores times log2(e) / sqrt(hd)): float32 (B,Hq,Sq), the layout of
    the forward kernel's second output."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1) * LOG2E
    return lse.reshape(B, Hq, Sq)


def attention_bwd_ref(q, k, v, dout, causal: bool = True, window: int = 0):
    """The plain backward: autograd through ``attention_ref``. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


BWD_TILE = 32       # the backward's shared-memory tiles, rows or keys


def attention_bwd_tiled_ref(q, k, v, out, lse, dout, causal: bool = True,
                            window: int = 0):
    """The backward kernel's arithmetic, step by step, in plain PyTorch:
    D = rowsum(dO * O) from the forward's rounded output; P recomputed
    from the forward's base-2 ``lse`` as exp2(q.k log2(e)/sqrt(hd) -
    lse), 0 where masked; dq over key tiles of ``BWD_TILE`` from the
    first that some row of the q tile may attend to; dk and dv per q
    head over q tiles from the first that attends to the key tile, in
    float32, then summed over the group's heads in order; P and dS never
    rounded. Used by the tests and the card check, never by the model.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(LOG2E * scale, dtype=torch.float32)
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, Sq, Hkv, G, hd)
    L = lse.reshape(B, Hkv, G, Sq)
    D = torch.einsum("bqhgd,bqhgd->bhgq", dof,
                     out.float().reshape(B, Sq, Hkv, G, hd))

    def probs(q0, q1, k0, k1):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf[:, k0:k1])
        p = torch.exp2(s * scale_log2 - L[..., q0:q1, None])
        ok = _mask(q1 - q0, k1 - k0, causal, window, dev, q0, k0)
        p = torch.where(ok, p, torch.zeros_like(p))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof[:, q0:q1], vf[:, k0:k1])
        return p, p * (dp - D[..., q0:q1, None])

    dq = torch.zeros(B, Hkv, G, Sq, hd, device=dev)
    for q0 in range(0, Sq, BWD_TILE):
        q1 = min(q0 + BWD_TILE, Sq)
        kv_end = min(Skv, q1) if causal else Skv
        kv_begin = max(0, q0 - window + 1) if window else 0
        for k0 in range(kv_begin // BWD_TILE * BWD_TILE, kv_end, BWD_TILE):
            k1 = min(k0 + BWD_TILE, Skv)
            _, ds = probs(q0, q1, k0, k1)
            dq[..., q0:q1, :] += torch.einsum("bhgqk,bkhd->bhgqd", ds,
                                              kf[:, k0:k1])
    dkp = torch.zeros(B, Hkv, G, Skv, hd, device=dev)
    dvp = torch.zeros_like(dkp)
    for k0 in range(0, Skv, BWD_TILE):
        k1 = min(k0 + BWD_TILE, Skv)
        q_begin = k0 if causal else 0
        q_end = min(Sq, k1 - 1 + window) if window else Sq
        for q0 in range(q_begin // BWD_TILE * BWD_TILE, q_end, BWD_TILE):
            q1 = min(q0 + BWD_TILE, Sq)
            p, ds = probs(q0, q1, k0, k1)
            dvp[..., k0:k1, :] += torch.einsum("bhgqk,bqhgd->bhgkd", p,
                                               dof[:, q0:q1])
            dkp[..., k0:k1, :] += torch.einsum("bhgqk,bqhgd->bhgkd", ds,
                                               qf[:, q0:q1])
    dk, dv = dkp[:, :, 0] * scale, dvp[:, :, 0]
    for g in range(1, G):
        dk = dk + dkp[:, :, g] * scale
        dv = dv + dvp[:, :, g]
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
