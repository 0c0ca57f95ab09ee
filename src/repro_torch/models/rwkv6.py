"""RWKV6 (Finch) block: time mix with data-dependent decay, and channel
mix. Counterpart of ``repro/models/rwkv6.py``.

The wkv recurrence keeps a per-head (hd x hd) float32 state:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with the data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)). It
runs through ``kernels/rwkv6_scan`` at every S, one decode step
included: the plain loop for CPU tensors, the CUDA kernel for CUDA
tensors, and in training its backward kernels (r, k, v and logw are
float32). (The reference runs its sequential jnp scan, or its Pallas
kernel for S > 1; the tests hold the port against both.)

Casts follow the reference: the token-shift mixes in float32; ``mr``,
``mk`` and ``mv`` cast to ``x``'s dtype for their projections, whose
results go to float32; ``g`` is ``silu`` in ``x``'s dtype; ``mw`` stays
float32 through the decay LoRA; the decay is ``-exp(clip(w_raw, -20,
8))``; the per-head group norm is float32 with eps 1e-5.

The state ``{"s": (B,H,hd,hd), "x_prev_tm": (B,D), "x_prev_cm": (B,D)}``,
all float32, is written in place (the kernel writes the final wkv state
over ``s``), so a decode step moves only its token and the state.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.common import new_param

_LORA = 64  # decay-LoRA rank


class RWKVMix(nn.Module):
    """Time-mix and channel-mix parameters under ``rwkv_template``'s
    names, shapes and init rules."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D = cfg.d_model
        H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        Fd = cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        # time mix
        self.mu = new_param((5, D), "small", **kw)       # r,k,v,w,g shifts
        self.w0 = new_param((D,), "small", **kw)
        self.w_lora_a = new_param((D, _LORA), "small", **kw)
        self.w_lora_b = new_param((_LORA, D), "small", **kw)
        self.wr = new_param((D, H, hd), **kw)
        self.wk = new_param((D, H, hd), **kw)
        self.wv = new_param((D, H, hd), **kw)
        self.wg = new_param((D, D), **kw)
        self.u = new_param((H, hd), "small", **kw)       # bonus
        self.gn_w = new_param((D,), "ones", **kw)
        self.gn_b = new_param((D,), "zeros", **kw)
        self.wo = new_param((H, hd, D), **kw)
        # channel mix
        self.mu_cm = new_param((2, D), "small", **kw)
        self.wk_cm = new_param((D, Fd), **kw)
        self.wv_cm = new_param((Fd, D), **kw)
        self.wr_cm = new_param((D, D), **kw)


def shift(x, prev):
    """Token shift: x_{t-1} per position. prev: (B,D) carry or None."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def groupnorm_heads(x, w, b, eps: float = 1e-5):
    """Per-head layernorm. x: (B,S,H,hd) -> (B,S,D)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    B, S, H, hd = x.shape
    xn = xn.reshape(B, S, H * hd)
    return xn * w.to(xn.dtype) + b.to(xn.dtype)


def rwkv_time_mix(p: RWKVMix, x, cfg, state: Optional[dict] = None):
    """x: (B,S,D) normed input. state: the block's state dict (``s``,
    ``x_prev_tm``) or None; updated in place. Returns (out, state)."""
    B, S, D = x.shape
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xf = x.float()
    xx = shift(xf, None if state is None else state["x_prev_tm"])
    d = xx - xf
    mr, mk, mv, mw, mg = (xf + d * p.mu[i].float() for i in range(5))

    def heads(m, w):
        return torch.einsum("bsd,dhk->bshk", m.to(x.dtype), w).float()

    r, k, v = heads(mr, p.wr), heads(mk, p.wk), heads(mv, p.wv)
    g = F.silu(mg.to(x.dtype) @ p.wg)

    w_raw = p.w0.float() + torch.tanh(mw @ p.w_lora_a.float()) \
        @ p.w_lora_b.float()
    logw = -torch.exp(torch.clamp(w_raw, -20.0, 8.0))    # (B,S,D), <= 0
    logw = logw.reshape(B, S, H, hd)

    u = p.u.float()
    if state is None:
        s0 = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=x.device)
        o, _ = rwkv6_scan(r, k, v, logw, u, s0)
    else:
        o, _ = rwkv6_scan(r, k, v, logw, u, state["s"], s_out=state["s"])
        state["x_prev_tm"].copy_(xf[:, -1])

    y = groupnorm_heads(o, p.gn_w.float(), p.gn_b.float())
    y = (y * g.float()).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", y.reshape(B, S, H, hd), p.wo)
    return out, state


def rwkv_channel_mix(p: RWKVMix, x, cfg, state: Optional[dict] = None):
    """x: (B,S,D) normed input. state: the block's state dict
    (``x_prev_cm``) or None; updated in place. Returns (out, state)."""
    xf = x.float()
    xx = shift(xf, None if state is None else state["x_prev_cm"])
    d = xx - xf
    mk = (xf + d * p.mu_cm[0].float()).to(x.dtype)
    mr = (xf + d * p.mu_cm[1].float()).to(x.dtype)
    kk = torch.square(torch.relu(mk @ p.wk_cm))
    out = torch.sigmoid(mr @ p.wr_cm) * (kk @ p.wv_cm)
    if state is not None:
        state["x_prev_cm"].copy_(xf[:, -1])
    return out, state
