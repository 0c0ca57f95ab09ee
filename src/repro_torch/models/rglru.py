"""RG-LRU recurrent block (Griffin / RecurrentGemma). Counterpart of
``repro/models/rglru.py``.

Residual branch: in-proj (two branches) -> causal depthwise conv1d ->
block-diagonal input/recurrence gates -> gated linear recurrence
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)`` -> GeLU-gated
out-proj. The recurrence, a per-channel diagonal affine scan, runs
through ``kernels/rglru_scan`` at every S, one decode step included: the
plain loop for CPU tensors, the CUDA kernel for CUDA tensors, and in
training its backward kernel (``a`` and the input are float32). (The
reference computes S = 1 inline and longer sequences by associative scan
or its Pallas kernel; the tests hold the port against all three.)

Casts follow the reference step by step: the projections in ``x``'s
dtype, the conv summed in ``u``'s dtype in the order i = 0..cw-1, the
gates, ``a`` and the recurrence input in float32, the GeLU gate (tanh
form, as ``jax.nn.gelu``) in float32 and cast to ``x``'s dtype before
``wo``. ``softplus`` is the log-add form ``logaddexp(x, 0)``, as
``jax.nn.softplus``.

The state ``{"h": (B,R) float32, "conv": (B,cw-1,R)}`` is written in
place: ``rglru_apply`` returns the dict it was given, so a decode step
moves only its token and the state. ``conv`` is float32 in the cache and
holds the values rounded to ``u``'s dtype, which the reference returns.

Under a ``ShardCtx`` that puts ``lru`` on the ``model`` axis each rank
holds its channels (and state), runs ``rglru_scan`` on them, and the out
projection's partial sums are added over ``model``: the input enters
through ``collectives.copy_to`` and the sum is ``all_sum``, so the
gradient crosses the ranks. Gates taken on every channel of a block
(``gather_u``) gather ``u`` and the biases over ``model`` and keep the
rank's channels of the result through ``copy_to``. Under sequence
parallelism (``seq`` on ``model``) the input is the rank's slice of the
sequence: the conv and the scan need the whole of it, so it is gathered
at the entry (``gather_seq``) and the out projection's partial sums are
reduce-scattered back to the slice (``scatter_seq``); with ``lru`` whole
every rank runs every channel and keeps its slice of the output.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import (all_gather, all_sum,
                                                 copy_to, gather_seq,
                                                 scatter_seq)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.common import (P, add_params, mark_seq_partial,
                                       seq_ctx, seq_slice)

_C = 8.0  # Griffin's recurrence-gate temperature


def rglru_template(cfg):
    D = cfg.d_model
    R = cfg.lru_width or D
    nb = cfg.lru_gate_blocks
    Rb = R // nb
    cw = cfg.conv1d_width
    return {
        "wy": P((D, R), ("embed", "lru")),          # gelu branch
        "wx": P((D, R), ("embed", "lru")),          # recurrent branch
        "conv_w": P((cw, R), ("conv", "lru"), "small"),
        "conv_b": P((R,), ("lru",), "zeros"),
        "gate_a": P((nb, Rb, Rb), ("blocks", None, None), "small"),
        "ba": P((R,), ("lru",), "zeros"),
        "gate_x": P((nb, Rb, Rb), ("blocks", None, None), "small"),
        "bx": P((R,), ("lru",), "zeros"),
        "lam": P((R,), ("lru",), "ones"),            # Λ (softplus'd)
        "wo": P((R, D), ("lru", "embed")),
    }


def rglru_state_template(cfg, batch: int):
    R = cfg.lru_width or cfg.d_model
    cw = cfg.conv1d_width
    return {
        "h": P((batch, R), ("batch", "lru"), "zeros"),
        "conv": P((batch, cw - 1, R), ("batch", "conv", "lru"), "zeros"),
    }


class RGLRU(nn.Module):
    """``wy``/``wx`` (D,R), ``conv_w`` (cw,R), ``conv_b`` (R,), ``gate_a``/
    ``gate_x`` (nb,R/nb,R/nb), ``ba``/``bx`` (R,), ``lam`` (R,), ``wo``
    (R,D), under ``rglru_template``'s init rules; under ``ctx`` this
    rank's channels where the rules shard ``lru`` (and its gate blocks
    where they shard ``blocks``)."""

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        self.ctx = ctx if ctx is not None and ctx.sharded("lru") else None
        # the gates need every channel of a block: gathered when the
        # channels are split over ranks but the blocks are not
        self.gather_u = self.ctx is not None and not ctx.sharded("blocks")
        self.seq = seq_ctx(ctx)
        add_params(self, rglru_template(cfg), ctx, device=device,
                   dtype=dtype)
        if self.seq is not None and self.ctx is None:
            mark_seq_partial(*self.parameters())   # each rank its slice


def causal_conv(p: RGLRU, u, conv_cache):
    """Depthwise causal conv, width cw. u: (B,S,R); conv_cache
    (B,cw-1,R) or None. Returns (out, the last cw-1 inputs)."""
    cw = p.conv_w.shape[0]
    if conv_cache is None:
        hist = torch.zeros(u.shape[0], cw - 1, u.shape[2], dtype=u.dtype,
                           device=u.device)
    else:
        hist = conv_cache.to(u.dtype)
    ext = torch.cat([hist, u], dim=1)                    # (B, S+cw-1, R)
    S = u.shape[1]
    out = sum(ext[:, i:i + S] * p.conv_w[i].to(u.dtype) for i in range(cw))
    out = out + p.conv_b.to(u.dtype)
    return out, ext[:, -(cw - 1):]


def gates(p: RGLRU, u):
    """Block-diagonal sigmoid gates in float32. u: (B,S,R) -> (r, i).
    When the rank holds a slice of the channels but every block, ``u``
    is gathered over ``model``, the gates taken on every channel and the
    rank's slice kept."""
    if p.gather_u:
        R_loc = u.shape[-1]
        c0 = p.ctx.index("model") * R_loc
        full = all_gather(u, p.ctx, dim=-1)
        r, i = (copy_to(g, p.ctx) for g in _gates(p, full, _full_bias(p)))
        return r[..., c0:c0 + R_loc], i[..., c0:c0 + R_loc]
    return _gates(p, u, (p.ba, p.bx))


def _full_bias(p: RGLRU):
    """``ba`` and ``bx`` over every channel, gathered over ``model``."""
    return tuple(all_gather(b, p.ctx, dim=-1) for b in (p.ba, p.bx))


def _gates(p: RGLRU, u, biases):
    B, S, R = u.shape
    ba, bx = biases
    nb = p.gate_a.shape[0]
    ub = u.reshape(B, S, nb, R // nb).float()
    ga = torch.einsum("bsnr,nrk->bsnk", ub, p.gate_a.float())
    gx = torch.einsum("bsnr,nrk->bsnk", ub, p.gate_x.float())
    r = torch.sigmoid(ga.reshape(B, S, R) + ba.float())
    i = torch.sigmoid(gx.reshape(B, S, R) + bx.float())
    return r, i


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear above x = 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_apply(p: RGLRU, x, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,D). state: {"h": (B,R) f32, "conv": (B,cw-1,R)} or None,
    updated in place. Returns (out (B,S,D), state)."""
    x = copy_to(x, p.ctx) if p.seq is None else gather_seq(x, p.seq)
    B, S, D = x.shape
    y = x @ p.wy
    u = x @ p.wx
    u, conv_new = causal_conv(p, u, None if state is None else state["conv"])

    r, i = gates(p, u)
    log_a = -_C * softplus(p.lam.float()) * r
    a = torch.exp(log_a)                                  # (B,S,R) f32
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * u.float())

    if state is None:
        h0 = torch.zeros(B, a.shape[-1], dtype=torch.float32,
                         device=x.device)
        hs, _ = rglru_scan(a, gated_in, h0)
    else:
        hs, _ = rglru_scan(a, gated_in, state["h"], h_out=state["h"])
        state["conv"].copy_(conv_new)
    gate = F.gelu(y.float(), approximate="tanh")
    out = (hs * gate).to(x.dtype) @ p.wo
    if p.seq is None:
        return all_sum(out, p.ctx), state
    if p.ctx is None:
        return seq_slice(out, p.seq), state
    return scatter_seq(out, p.seq), state
