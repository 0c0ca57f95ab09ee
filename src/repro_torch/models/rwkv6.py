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

Under a ``ShardCtx`` that puts ``heads`` on the ``model`` axis each rank
holds its wkv heads and their state, runs ``rwkv6_scan`` on them (the
decay, gate and group norm taken on those heads' channels), and the out
projection's partial sums are added over ``model``; the channel mix
splits its hidden units where ``ff`` is sharded, its partial sums added
before the receptance gate. Every tensor replicated over ``model`` that
enters a rank's heads or hidden units (the mixed inputs, the decay
LoRA's hidden, and the replicated leaves cut to the rank's channels by
``RWKVMix.channels``) goes through ``collectives.copy_to``, and the sums
are ``all_sum``, so the gradient crosses the ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import all_sum, copy_to
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.common import P, add_params

_LORA = 64  # decay-LoRA rank


def rwkv_template(cfg):
    D = cfg.d_model
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    Fd = cfg.d_ff
    return {
        # --- time mix ---
        "mu": P((5, D), (None, "embed"), "small"),        # r,k,v,w,g shifts
        "w0": P((D,), ("embed",), "small"),
        "w_lora_a": P((D, _LORA), ("embed", None), "small"),
        "w_lora_b": P((_LORA, D), (None, "embed"), "small"),
        "wr": P((D, H, hd), ("embed", "heads", None)),
        "wk": P((D, H, hd), ("embed", "heads", None)),
        "wv": P((D, H, hd), ("embed", "heads", None)),
        "wg": P((D, D), ("embed", None)),
        "u": P((H, hd), ("heads", None), "small"),        # bonus
        "gn_w": P((D,), ("embed",), "ones"),
        "gn_b": P((D,), ("embed",), "zeros"),
        "wo": P((H, hd, D), ("heads", None, "embed")),
        # --- channel mix ---
        "mu_cm": P((2, D), (None, "embed"), "small"),
        "wk_cm": P((D, Fd), ("embed", "ff")),
        "wv_cm": P((Fd, D), ("ff", "embed")),
        "wr_cm": P((D, D), ("embed", None)),
    }


def rwkv_state_template(cfg, batch: int):
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {
        "s": P((batch, H, hd, hd), ("batch", "heads", None, None), "zeros"),
        "x_prev_tm": P((batch, cfg.d_model), ("batch", "act_embed"), "zeros"),
        "x_prev_cm": P((batch, cfg.d_model), ("batch", "act_embed"), "zeros"),
    }


class RWKVMix(nn.Module):
    """Time-mix and channel-mix parameters under ``rwkv_template``'s
    names, shapes and init rules; under ``ctx`` this rank's wkv heads
    (``wr``, ``wk``, ``wv``, ``u``, ``wo``) and channel-mix hidden units
    where the rules shard ``heads`` and ``ff``."""

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        self.heads_ctx = (ctx if ctx is not None and ctx.sharded("heads")
                          else None)
        self.ff_ctx = ctx if ctx is not None and ctx.sharded("ff") else None
        add_params(self, rwkv_template(cfg), ctx, device=device,
                   dtype=dtype)

    def channels(self, t, dim: int = -1):
        """``t``'s slice along ``dim`` (of d_model) that this rank's
        heads cover; ``t`` itself when the heads are whole. ``t`` is
        replicated over ``model``: its gradient is summed there."""
        if self.heads_ctx is None:
            return t
        n = self.wr.shape[1] * self.wr.shape[2]
        t = copy_to(t, self.heads_ctx)
        return t.narrow(dim, self.heads_ctx.index("model") * n, n)


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
    H, hd = p.wr.shape[1], cfg.rwkv_head_dim
    xf = x.float()
    xx = shift(xf, None if state is None else state["x_prev_tm"])
    d = xx - xf
    mr, mk, mv, mw, mg = (xf + d * p.mu[i].float() for i in range(5))

    hc = p.heads_ctx

    def heads(m, w):
        return torch.einsum("bsd,dhk->bshk", copy_to(m, hc).to(x.dtype),
                            w).float()

    r, k, v = heads(mr, p.wr), heads(mk, p.wk), heads(mv, p.wv)
    g = F.silu(copy_to(mg, hc).to(x.dtype) @ p.channels(p.wg))

    w_raw = p.channels(p.w0).float() + copy_to(torch.tanh(
        mw @ p.w_lora_a.float()), hc) @ p.channels(p.w_lora_b).float()
    logw = -torch.exp(torch.clamp(w_raw, -20.0, 8.0))    # (B,S,D), <= 0
    logw = logw.reshape(B, S, H, hd)

    u = p.u.float()
    if state is None:
        s0 = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=x.device)
        o, _ = rwkv6_scan(r, k, v, logw, u, s0)
    else:
        o, _ = rwkv6_scan(r, k, v, logw, u, state["s"], s_out=state["s"])
        state["x_prev_tm"].copy_(xf[:, -1])

    y = groupnorm_heads(o, p.channels(p.gn_w).float(),
                        p.channels(p.gn_b).float())
    y = (y * g.float()).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", y.reshape(B, S, H, hd), p.wo)
    return all_sum(out, hc), state


def rwkv_channel_mix(p: RWKVMix, x, cfg, state: Optional[dict] = None):
    """x: (B,S,D) normed input. state: the block's state dict
    (``x_prev_cm``) or None; updated in place. Returns (out, state)."""
    xf = x.float()
    xx = shift(xf, None if state is None else state["x_prev_cm"])
    d = xx - xf
    mk = (xf + d * p.mu_cm[0].float()).to(x.dtype)
    mr = (xf + d * p.mu_cm[1].float()).to(x.dtype)
    kk = torch.square(torch.relu(copy_to(mk, p.ff_ctx) @ p.wk_cm))
    out = torch.sigmoid(mr @ p.wr_cm) * all_sum(kk @ p.wv_cm, p.ff_ctx)
    if state is not None:
        state["x_prev_cm"].copy_(xf[:, -1])
    return out, state
