"""Decoder-stack assembly for every architecture of the pool.
Counterpart of ``repro/models/transformer.py``.

The model is an ``nn.Module`` (``Transformer``) whose blocks sit in one
flat ``layers`` list in global layer order; the reference's scan groups
(``layer_groups``) only decide how weights are drawn and carried across.
Blocks come in three kinds: attention (``attn``, ``local``,
``attn_dense``), RG-LRU (``rglru``, RecurrentGemma) and RWKV6
(``rwkv``). An MoE config's ``attn`` blocks take a ``models.moe.MoE`` in
place of the dense MLP; its ``attn_dense`` blocks (Kimi K2's leading
layer) keep the MLP. Every block returns ``(x, aux)``, aux the MoE
load-balance loss or None. ``forward`` covers train/prefill (S tokens,
optional cache write) and decode (one token against the cache). Full
sequences go through ``kernels/flash_attention`` (on CPU tensors above
``attention.BLOCKED_ABOVE`` tokens through ``attention.blocked_attention``,
as the reference's model does), a decode step through
``kernels/decode_attention``, and the recurrences at every S through
``kernels/rglru_scan`` and ``kernels/rwkv6_scan``: on CPU tensors those
return their plain versions, on CUDA tensors they launch the kernels.

The cache is a list of per-layer dicts: ``{"k", "v", "pos"}`` for an
attention layer, the recurrent state ``{"h", "conv"}`` for an RG-LRU
layer and ``{"s", "x_prev_tm", "x_prev_cm"}`` for an RWKV6 layer.
Unlike the reference, which returns a new cache, prefill and decode
write the cache in place (and return it), so a decode step moves no more
bytes than its one token and the recurrent states.

Training (``mode="train"`` with grad enabled, ``train/trainer.py``)
differentiates the same modules: on CUDA tensors through the backward
kernels of ``flash_attention``, ``rglru_scan`` and ``rwkv6_scan`` (each
wrapper's ``torch.autograd.Function``), so every dense and recurrent
arch trains on the card. Parameters are created frozen (serving runs
under ``inference_mode``); the trainer turns them on.

Not ported yet: the mesh paths (``ShardCtx``, the vocab-sharded
embedding lookup, padded heads, MoE's ``shard_map`` modes), which wait
for the mesh tooling.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.common import (Norm, init_tensor, new_param,
                                       padded_vocab, torch_dtype)
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, rglru_apply
from repro_torch.models.rwkv6 import RWKVMix, rwkv_channel_mix, rwkv_time_mix

INT32_MAX = 2 ** 31 - 1
ATTENTION_KINDS = ("attn", "local", "attn_dense")
RECURRENT_KINDS = ("rglru", "rwkv")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def layer_groups(cfg) -> List[Tuple[Tuple[str, ...], int]]:
    """[(kinds_in_cycle, repeats), ...] covering all n_layers in order."""
    kinds = list(cfg.layer_kinds())
    groups: List[Tuple[Tuple[str, ...], int]] = []
    i = 0
    if cfg.moe and cfg.first_k_dense:
        groups.append((("attn_dense",), cfg.first_k_dense))
        i = cfg.first_k_dense
    rest = kinds[i:]
    if not rest:
        return groups
    p = tuple(cfg.block_pattern) if len(set(rest)) > 1 else (rest[0],)
    n_cyc = len(rest) // len(p)
    if n_cyc:
        groups.append((p, n_cyc))
    for k in rest[n_cyc * len(p):]:
        groups.append(((k,), 1))
    return groups


def group_layers(cfg):
    """For each group of ``layer_groups``: (gi, kinds, reps, idx) where
    ``idx[r][i]`` is the global layer index of cycle ``r``, block ``i``."""
    out, off = [], 0
    for gi, (kinds, reps) in enumerate(layer_groups(cfg)):
        idx = [[off + r * len(kinds) + i for i in range(len(kinds))]
               for r in range(reps)]
        out.append((gi, kinds, reps, idx))
        off += len(kinds) * reps
    return out


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a layer kind the model does not know."""
    for kind in cfg.layer_kinds():
        if kind not in ATTENTION_KINDS + RECURRENT_KINDS:
            raise ValueError(kind)


def attention_window(cfg, kind: str) -> int:
    return cfg.window if (kind == "local" or cfg.attn_type == "swa") else 0


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class AttentionBlock(nn.Module):
    """Pre-norm attention + dense MLP, or MoE for an MoE config's
    ``attn`` kind, as ``_attention_block`` (kinds ``attn``, ``local``
    and ``attn_dense``)."""

    def __init__(self, cfg, kind: str, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.kind = kind
        self.window = attention_window(cfg, kind)
        self.ln1 = Norm(cfg, **kw)
        self.ln2 = Norm(cfg, **kw)
        self.attn = attn.Attention(cfg, **kw)
        self.mlp = (MoE(cfg, **kw) if cfg.moe and kind == "attn"
                    else MLP(cfg, **kw))

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        cfg = self.cfg
        h = self.ln1(x)
        q, k, v = attn.qkv_proj(self.attn, h, cfg, positions)
        if mode == "decode":
            o = self._decode(q, k, v, positions, cache, t)
        elif q.device.type == "cpu" and q.shape[1] > attn.BLOCKED_ABOVE:
            o = attn.blocked_attention(q, k, v, positions, positions,
                                       self.window)
        else:
            o = flash_attention(q, k, v, causal=True, window=self.window)
        if cache is not None and mode != "decode":
            _prefill_write(cache, k, v, positions)
        x = x + attn.out_proj(self.attn, o)
        if isinstance(self.mlp, MoE):
            m, aux = self.mlp(self.ln2(x))
            return x + m, aux
        return x + self.mlp(self.ln2(x)), None

    def _decode(self, q, k, v, positions, cache, t):
        """Write the token at slot ``t % C``, then attend to the cache."""
        C = cache["k"].shape[1]
        slot = int(t) % C
        q_pos = positions[:, 0].to(torch.int32).contiguous()
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = q_pos
        B, _, Hq, hd = q.shape
        o = decode_attention(q.reshape(B, Hq, hd), cache["k"], cache["v"],
                             cache["pos"], q_pos, window=self.window)
        return o.reshape(B, 1, Hq, hd)


def _prefill_write(cache, k, v, positions) -> None:
    """Persist a prefill's KV in place. Slots [0, S) when S < C; else the
    last C tokens, rolled so that position p lands at slot p % C (the
    reference's ring convention)."""
    C = cache["k"].shape[1]
    S = k.shape[1]
    if S >= C:
        sh = (S - C) % C
        for name, val in (("k", k), ("v", v), ("pos", positions)):
            cache[name].copy_(torch.roll(val[:, -C:], sh, dims=1))
    else:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        cache["pos"][:, :S] = positions.to(torch.int32)


class RGLRUBlock(nn.Module):
    """Pre-norm RG-LRU + dense MLP, as ``_rglru_block`` (kind
    ``rglru``). The cache is the layer's recurrent state, written in
    place; positions, t and mode play no part."""

    kind = "rglru"

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg, **kw)
        self.lru = RGLRU(cfg, **kw)
        self.ln2 = Norm(cfg, **kw)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        o, _ = rglru_apply(self.lru, self.ln1(x), cache)
        x = x + o
        return x + self.mlp(self.ln2(x)), None


class RWKVBlock(nn.Module):
    """Pre-norm RWKV6 time mix, then channel mix, as ``_rwkv_block``
    (kind ``rwkv``). The cache is the layer's recurrent state, written
    in place; positions, t and mode play no part."""

    kind = "rwkv"

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = Norm(cfg, **kw)
        self.mix = RWKVMix(cfg, **kw)
        self.ln2 = Norm(cfg, **kw)

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        o, _ = rwkv_time_mix(self.mix, self.ln1(x), self.cfg, cache)
        x = x + o
        o2, _ = rwkv_channel_mix(self.mix, self.ln2(x), self.cfg, cache)
        return x + o2, None


def make_block(cfg, kind: str, *, device, dtype) -> nn.Module:
    if kind == "rglru":
        return RGLRUBlock(cfg, device=device, dtype=dtype)
    if kind == "rwkv":
        return RWKVBlock(cfg, device=device, dtype=dtype)
    return AttentionBlock(cfg, kind, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """``embed`` (Vp, D), ``final_norm``, ``unembed`` (D, Vp) unless the
    embeddings are tied, and ``layers`` in global order. Parameters are
    allocated uninitialized: use ``init_model`` or
    ``interop.model_from_reference``."""

    def __init__(self, cfg, device="cuda", dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(device=dev, dtype=dt)
        self.cfg = cfg
        self.embed = new_param((padded_vocab(cfg), cfg.d_model), "embed",
                               0.02, **kw)
        self.final_norm = Norm(cfg, **kw)
        if not cfg.tie_embeddings:
            self.unembed = new_param((cfg.d_model, padded_vocab(cfg)), **kw)
        self.layers = nn.ModuleList(
            make_block(cfg, kind, **kw) for kind in cfg.layer_kinds())

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg, generator: Optional[torch.Generator] = None,
               device="cuda", dtype=None) -> Transformer:
    """The model with weights drawn under the reference's init rules, in
    ``cfg.param_dtype`` unless ``dtype`` is given. As in the reference,
    a group of ``reps > 1`` layers draws each leaf once with its stacked
    ``(reps, ...)`` shape (so its fan-in counts the layer axis), then
    hands layer r its slice. ``generator`` defaults to seed 0 on the
    model's device."""
    model = Transformer(cfg, device, dtype)
    if generator is None:
        generator = torch.Generator(model.device).manual_seed(0)
    with torch.no_grad():
        for name in ("embed", "unembed"):
            if hasattr(model, name):
                _draw(getattr(model, name), generator)
        for p in model.final_norm.parameters():
            _draw(p, generator)
        for _, kinds, reps, idx in group_layers(cfg):
            for i in range(len(kinds)):
                blocks = [model.layers[row[i]] for row in idx]
                for name, p in blocks[0].named_parameters():
                    same = [b.get_parameter(name) for b in blocks]
                    shape = (reps, *p.shape) if reps > 1 else tuple(p.shape)
                    val = init_tensor(shape, p.init, p.init_scale, generator,
                                      p.dtype)
                    for r, q in enumerate(same):
                        q.copy_(val[r] if reps > 1 else val)
                    # freed before the next leaf is drawn: a stacked
                    # expert leaf is 16.6 GB in float32 at full width
                    del val
    return model


def _draw(p, generator) -> None:
    p.copy_(init_tensor(tuple(p.shape), p.init, p.init_scale, generator,
                        p.dtype))


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def cache_capacity(cfg, kind: str, max_seq: int) -> int:
    if kind == "local" or (cfg.attn_type == "swa" and cfg.window):
        return min(max_seq, cfg.window)
    return max_seq


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda") -> list:
    """Empty cache, one dict per layer. Attention layers: ``k``/``v``
    (B, C, Hkv, hd) in ``dtype`` and ``pos`` (B, C) int32 filled with
    INT32_MAX, so masks exclude unfilled slots; C = min(max_seq, window)
    for local/SWA. Recurrent layers: their zeroed float32 state, as the
    reference's ``init_cache`` keeps it: ``h`` (B, R) and ``conv``
    (B, cw-1, R) for ``rglru``; ``s`` (B, H, hd, hd), ``x_prev_tm`` and
    ``x_prev_cm`` (B, D) for ``rwkv``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    out = []
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            R = cfg.lru_width or cfg.d_model
            out.append({
                "h": torch.zeros(batch, R, **f32),
                "conv": torch.zeros(batch, cfg.conv1d_width - 1, R, **f32),
            })
            continue
        if kind == "rwkv":
            H, rhd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
            out.append({
                "s": torch.zeros(batch, H, rhd, rhd, **f32),
                "x_prev_tm": torch.zeros(batch, cfg.d_model, **f32),
                "x_prev_cm": torch.zeros(batch, cfg.d_model, **f32),
            })
            continue
        C = cache_capacity(cfg, kind, max_seq)
        out.append({
            "k": torch.zeros(batch, C, Hkv, hd, dtype=dt, device=dev),
            "v": torch.zeros(batch, C, Hkv, hd, dtype=dt, device=dev),
            "pos": torch.full((batch, C), INT32_MAX, dtype=torch.int32,
                              device=dev),
        })
    return out


# ---------------------------------------------------------------------------
# embedding / logits / forward
# ---------------------------------------------------------------------------


def embed_lookup(model: Transformer, tokens):
    return torch.nn.functional.embedding(tokens.long(), model.embed)


def unembed_weight(model: Transformer):
    if model.cfg.tie_embeddings:
        return model.embed.t()
    return model.unembed


def logits_fn(model: Transformer, hidden):
    """Full logits (B,S,Vp) over the padded vocab."""
    return hidden @ unembed_weight(model)


def forward(model: Transformer, *, tokens=None, embeds=None, positions,
            cache=None, t=None, mode: str = "train"):
    """Returns (hidden (B,S,D), cache, aux_loss), aux_loss the sum of the
    MoE layers' load-balance losses (zero without MoE). The cache, when
    given, is written in place and returned."""
    dt = torch_dtype(model.cfg.dtype)
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = embed_lookup(model, tokens).to(dt)
    x, aux = apply_layers(model, x, positions, 0, len(model.layers), cache,
                          t, mode)
    return model.final_norm(x), cache, aux


def apply_layers(model: Transformer, x, positions, lo: int, hi: int,
                 cache=None, t=None, mode: str = "train"):
    """Layers [lo, hi) -> (x, the sum of their MoE aux losses, float32
    zero without MoE). With ``cfg.remat``, a training forward that
    autograd records keeps only each layer's input and runs the layer
    again in the backward (``torch.utils.checkpoint``, non-reentrant), as
    the reference's ``jax.checkpoint`` of each scanned cycle does: the
    same values, each attention forward launched twice a step."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (model.cfg.remat and mode == "train" and cache is None
             and torch.is_grad_enabled())
    for i in range(lo, hi):
        layer = model.layers[i]
        if remat:
            x, a = checkpoint(layer, x, positions, None, t, mode,
                              use_reentrant=False)
        else:
            x, a = layer(x, positions, None if cache is None else cache[i],
                         t, mode)
        if a is not None:
            aux = aux + a
    return x, aux
