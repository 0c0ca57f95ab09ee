"""Plain PyTorch version of the decode-attention kernel: one query token
per (batch row, q head) against a ring-buffer KV cache. Counterpart of
``repro/kernels/decode_attention/ref.py::decode_attention_ref``.

It is what ``ops.decode_attention`` returns for tensors on the CPU, and
what the CUDA kernel is held against on the card. A slot counts when
``kv_pos <= q_pos`` (and ``q_pos - kv_pos < window`` when a window is
set); ``INT32_MAX`` marks an empty slot. The masks are computed on the
integer positions in int64, never in float. Scores in float32, masked
with -1e30, scale ``1/sqrt(hd)``; output in q's dtype. With
``return_lse`` each also returns the row's natural log-sum-exp of the
scaled scores, max + log(sum exp(s - max)), (B,Hq) float32: two slices
of a cache, each attended with its log-sum-exp, merge to the whole
(``merge_lse``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
SUB_TILE = 32             # slots per sub-tile of the kernel


def decode_attention_ref(q, k, v, kv_pos, q_pos, window: int = 0,
                         return_lse: bool = False):
    """q (B,Hq,hd); k, v (B,T,Hkv,hd); kv_pos (B,T); q_pos (B,) ->
    (B,Hq,hd) (and the (B,Hq) log-sum-exp with ``return_lse``)."""
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
    o = o.reshape(B, Hq, hd).to(q.dtype)
    if return_lse:
        lse = (m + torch.log(p.sum(-1, keepdim=True)))[..., 0]
        return o, lse.reshape(B, Hq)
    return o


def merge_lse(parts, lses):
    """Attention over a cache cut into slices, from each slice's output
    (R, B, Hq, hd) and log-sum-exp (R, B, Hq): the slices weighed by
    exp(lse - max lse), summed in slice order in float32, in the parts'
    dtype."""
    top = lses.amax(0)
    w = torch.exp(lses - top)
    o = (w[..., None] * parts.float()).sum(0) / w.sum(0)[..., None]
    return o.to(parts.dtype)


def decode_attention_split_ref(q, k, v, kv_pos, q_pos, window: int = 0,
                               n_split: int = 1, chunk: int | None = None,
                               return_lse: bool = False):
    """The kernel's split-T arithmetic in plain PyTorch: the T slots cut
    into ``n_split`` splits of ``chunk`` slots; a 32-slot sub-tile with
    no allowed slot is left out of its split, unless the row has no
    allowed slot at all, when every slot enters, scored -1e30. Each split
    gives float32 partials (m, l, acc); they merge in split order with
    weights exp(m - max m), a split that saw no slot weighing 0. Used by
    the tests and the card check, never by the model. Output in q's
    dtype."""
    B, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sub = SUB_TILE
    if chunk is None:
        per_split = -(-T // n_split)
        chunk = -(-per_split // sub) * sub
    if chunk % sub or not (n_split - 1) * chunk < T <= n_split * chunk:
        raise ValueError(f"{n_split} splits of {chunk} slots do not cut "
                         f"{T} slots")
    pad = n_split * chunk - T
    qf = q.reshape(B, Hkv, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bhgd,bthd->bhgt", qf, k.float())
    kp = kv_pos.long()
    qp = q_pos.long()[:, None]
    allowed = kp <= qp
    if window:
        allowed = allowed & (qp - kp < window)
    live_sub = torch.nn.functional.pad(allowed, (0, pad)).reshape(
        B, -1, sub).any(-1).repeat_interleave(sub, dim=1)[:, :T]
    used = live_sub | ~allowed.any(-1, keepdim=True)
    s = s.masked_fill(~allowed[:, None, None], NEG_INF)
    s = s.masked_fill(~used[:, None, None], float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(B, Hkv, G, n_split, chunk)
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    vv = vv.reshape(B, n_split, chunk, Hkv, hd)
    m = s.amax(-1)                                    # (B,Hkv,G,n_split)
    seen = m > float("-inf")
    p = torch.exp(s - torch.where(seen, m, torch.zeros_like(m))[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgnc,bnchd->bhgnd", p, vv)
    w = torch.where(seen, torch.exp(m - m.amax(-1, keepdim=True)),
                    torch.zeros_like(m))
    den = (w * l).sum(-1)
    den = torch.where(den == 0, torch.ones_like(den), den)
    o = (w[..., None] * acc).sum(-2) / den[..., None]
    o = o.reshape(B, Hq, hd).to(q.dtype)
    if return_lse:
        return o, (m.amax(-1) + torch.log(den)).reshape(B, Hq)
    return o
