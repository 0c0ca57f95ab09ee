"""Attention: GQA + RoPE projections, full/sliding-window masks, and the
naive and decode paths. Counterpart of ``repro/models/attention.py``.

The model's hot paths are the kernels (``kernels/flash_attention`` for
full sequences, ``kernels/decode_attention`` for one step). The plain
functions here are the reference's jnp paths, kept as the oracles the
tests hold the port against: ``naive_attention`` and
``decode_attention``. ``blocked_attention`` is not ported (ROADMAP).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import new_param, rope

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (D,Hq,hd), ``wk``/``wv`` (D,Hkv,hd), ``wo`` (Hq,hd,D), and
    ``bq``/``bk``/``bv`` when the config has a QKV bias."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(device=device, dtype=dtype)
        self.wq = new_param((D, Hq, hd), **kw)
        self.wk = new_param((D, Hkv, hd), **kw)
        self.wv = new_param((D, Hkv, hd), **kw)
        self.wo = new_param((Hq, hd, D), **kw)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = new_param((Hq, hd), "zeros", **kw)
            self.bk = new_param((Hkv, hd), "zeros", **kw)
            self.bv = new_param((Hkv, hd), "zeros", **kw)


def qkv_proj(p: Attention, x, cfg, positions):
    """x: (B,S,D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
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
