"""Attention: GQA + RoPE projections, full/sliding-window masks, and the
naive, blocked and decode paths. Counterpart of
``repro/models/attention.py``.

The model's hot paths are the kernels (``kernels/flash_attention`` for
full sequences, ``kernels/decode_attention`` for one step). The plain
functions here are the reference's jnp paths: ``naive_attention`` and
``decode_attention`` are the oracles the tests hold the port against,
and ``blocked_attention`` (an online softmax over KV blocks, never the
(Sq, Skv) scores) is what the model runs on CPU tensors above
``BLOCKED_ABOVE`` tokens, as the reference's model does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import P, add_params, rope

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
# the reference's model takes blocked_attention above this many tokens
# and naive_attention at or below it (repro/models/transformer.py)
BLOCKED_ABOVE = 1024


def attn_template(cfg):
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {
        "wq": P((D, Hq, hd), ("embed", "heads", None)),
        "wk": P((D, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": P((D, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": P((Hq, hd, D), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = P((Hq, hd), ("heads", None), "zeros")
        t["bk"] = P((Hkv, hd), ("kv_heads", None), "zeros")
        t["bv"] = P((Hkv, hd), ("kv_heads", None), "zeros")
    return t


class Attention(nn.Module):
    """``wq`` (D,Hq,hd), ``wk``/``wv`` (D,Hkv,hd), ``wo`` (Hq,hd,D), and
    ``bq``/``bk``/``bv`` when the config has a QKV bias; under ``ctx``
    this rank's heads of each where the rules shard them."""

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        self.qkv_bias = cfg.qkv_bias
        add_params(self, attn_template(cfg), ctx, device=device,
                   dtype=dtype)


def qkv_proj(p: Attention, x, cfg, positions, xq=None, xkv=None):
    """x: (B,S,D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with RoPE applied.
    ``xq`` and ``xkv``, where given, stand for ``x`` in the query and in
    the key and value products (the same values: a mesh path's
    ``copy_to`` of it)."""
    xq = x if xq is None else xq
    xkv = x if xkv is None else xkv
    q = torch.einsum("bsd,dhk->bshk", xq, p.wq)
    k = torch.einsum("bsd,dhk->bshk", xkv, p.wk)
    v = torch.einsum("bsd,dhk->bshk", xkv, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Attention, o):
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def _mask(qp, kp, window: int):
    """qp: (..., Sq), kp: (..., Skv) -> bool (..., Sq, Skv). Causal + SWA.
    Integer positions, compared in int64."""
    qp, kp = qp.long(), kp.long()
    m = kp[..., None, :] <= qp[..., :, None]
    if window:
        m = m & ((qp[..., :, None] - kp[..., None, :]) < window)
    return m


def naive_attention(q, k, v, q_pos, kv_pos, window: int = 0):
    """Oracle path. q:(B,Sq,Hq,hd) k/v:(B,Skv,Hkv,hd)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(hd)
    m = _mask(q_pos, kv_pos, window)[:, None, None]       # (B,1,1,Sq,Skv)
    s = s.masked_fill(~m, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def _pad_seq(x, blk, value=0):
    """Pad dim 1 of ``x`` up to a multiple of ``blk`` with ``value``."""
    r = (-x.shape[1]) % blk
    if r == 0:
        return x
    fill = x.new_full((x.shape[0], r, *x.shape[2:]), value)
    return torch.cat([x, fill], dim=1)


def _kv_block_step(carry, s, vci):
    """One online-softmax step over a KV block's masked scores ``s``
    (..., q, k) and values ``vci`` -> the new (m, l, acc)."""
    m_run, l_run, acc = carry
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    corr = torch.exp(m_run - m_new)
    p_ = torch.exp(s - m_new[..., None])
    l_new = l_run * corr + p_.sum(dim=-1)
    return m_new, l_new, acc * corr[..., None] + p_ @ vci


def blocked_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                      q_block: int = 512, kv_block: int = 1024,
                      causal_skip: bool = False):
    """Online-softmax attention; never materializes (Sq, Skv) scores.
    q:(B,Sq,Hq,hd) k/v:(B,Skv,Hkv,hd), positions (B,S) int.

    Padded KV slots get INT32_MAX positions, so no row attends to them;
    a row that attends to nothing divides by 1. With ``causal_skip``
    q-block i visits only KV blocks 0..ceil((i+1) q_block / kv_block)-1
    (the reference's triangular schedule), which needs positions aligned
    with the array index (prefill)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qb = _pad_seq(q, q_block)
    qpb = _pad_seq(q_pos, q_block)       # padded q rows are sliced off
    kb, vb = _pad_seq(k, kv_block), _pad_seq(v, kv_block)
    kpb = _pad_seq(kv_pos, kv_block, INT32_MAX)
    NQ, NK = qb.shape[1] // q_block, kb.shape[1] // kv_block
    scale = 1.0 / math.sqrt(hd)
    # (B, NQ, Hkv, G, q_block, hd) queries; (B, NK, Hkv, kv_block, hd) K/V
    qf = qb.reshape(B, NQ, q_block, Hkv, G, hd).permute(0, 1, 3, 4, 2, 5
                                                         ).float()
    qpq = qpb.reshape(B, NQ, q_block)
    kc = kb.reshape(B, NK, kv_block, Hkv, hd).transpose(2, 3).float()
    vc = vb.reshape(B, NK, kv_block, Hkv, hd).transpose(2, 3).float()
    kpc = kpb.reshape(B, NK, kv_block)

    def init(*lead):
        return (torch.full((*lead, q_block), NEG_INF, device=q.device),
                torch.zeros((*lead, q_block), device=q.device),
                torch.zeros((*lead, q_block, hd), device=q.device))

    if not causal_skip:
        carry = init(B, NQ, Hkv, G)
        for j in range(NK):
            s = (qf @ kc[:, j, None, :, None].transpose(-1, -2)) * scale
            msk = _mask(qpq, kpc[:, j, None], window)  # (B,NQ,QB,KB)
            s = s.masked_fill(~msk[:, :, None, None], NEG_INF)
            carry = _kv_block_step(carry, s, vc[:, j, None, :, None])
        _, l_f, acc = carry
        l_f = torch.where(l_f == 0, 1.0, l_f)
        o = (acc / l_f[..., None]).permute(0, 1, 4, 2, 3, 5)
    else:
        outs = []
        for qi in range(NQ):
            qblk, qpi = qf[:, qi], qpq[:, qi]     # (B,Hkv,G,QB,hd), (B,QB)
            carry = init(B, Hkv, G)
            hi = min(((qi + 1) * q_block + kv_block - 1) // kv_block, NK)
            for j in range(hi):
                s = (qblk @ kc[:, j, :, None].transpose(-1, -2)) * scale
                msk = _mask(qpi, kpc[:, j], window)      # (B,QB,KB)
                s = s.masked_fill(~msk[:, None, None], NEG_INF)
                carry = _kv_block_step(carry, s, vc[:, j, :, None])
            _, l_f, acc = carry
            l_f = torch.where(l_f == 0, 1.0, l_f)
            outs.append((acc / l_f[..., None]).permute(0, 3, 1, 2, 4))
        o = torch.stack(outs, dim=1)              # (B,NQ,QB,Hkv,G,hd)
    o = o.reshape(B, NQ * q_block, Hq, hd)[:, :Sq]
    return o.to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, window: int = 0):
    """One-token query vs cache, the reference model's decode route.
    q:(B,1,Hq,hd), cache:(B,T,Hkv,hd), kv_pos (B,T), q_pos (B,1).
    Unfilled slots carry kv_pos = INT32_MAX, so the causal mask drops
    them."""
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bthd->bhgt", qf, k_cache.float())
    s = s / math.sqrt(hd)
    m = _mask(q_pos, kv_pos, window)                      # (B,1,T)
    s = s.masked_fill(~m[:, :, None], NEG_INF)            # (B,Hkv,G,T)
    mx = s.amax(dim=-1, keepdim=True)
    p_ = torch.exp(s - mx)
    l = p_.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgt,bthd->bhgd", p_ / l, v_cache.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)
