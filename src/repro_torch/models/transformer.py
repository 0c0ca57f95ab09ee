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

Templates: ``model_template`` and ``cache_template`` (with the block
templates they call) are the reference's, leaf for leaf: ``P(shape,
axes, init, scale)`` trees with no tensors, which
``distributed.sharding.spec_tree`` maps to specs.

Under a ``ShardCtx`` (``Transformer(cfg, ctx=...)``: serving or
training over a ``("data", "model")`` mesh) each rank holds its shards
and runs the reference's partitioning as local code with explicit
collectives over the ``model`` axis (``distributed.collectives``: each
carries its gradient, ``all_sum`` where the ranks' partial sums meet,
``copy_to`` where a tensor replicated over ``model`` enters a rank's own
work), the form of the reference's own ``shard_map`` regions: the
embedding is a
masked lookup of the rank's vocab rows, summed; the logits are the
rank's vocab columns, gathered; attention runs the rank's heads (in
``attn_sharding="padded"`` mode, query heads zero-padded per KV group,
``_pad_group``) and its row-parallel output projection is summed; the
MLP's and the recurrences' out projections likewise (RG-LRU on the
rank's channels through ``rglru_scan``, RWKV6 on its heads through
``rwkv6_scan``); MoE runs its ``"expert"`` or ``"tensor"`` mode. The
caller splits the batch over ``data`` (``runtime/serve.py``). Where the
rules put the KV cache's sequence on ``model`` (a KV head count the axis
does not divide), each rank holds its slice of the ring, and a decode
step merges the ranks' partial attention by log-sum-exp
(``decode_attention`` with ``return_lse``): the cache is never
gathered. Under FSDP (``embed`` on ``data``) each rank also holds its
part of every ``embed`` dim, and each module's forward reads its leaves
gathered whole over ``data`` (``common.gathered``; the gradient is
reduce-scattered back), again in a remat's recompute.

Under sequence parallelism (``seq`` on ``model``: the reference's
``ctx.constrain(x, ("batch", "seq", "act_embed"))``) each rank holds its
S/m slice of the residual stream between blocks, and the norms run on
it. A block gathers the sequence where it enters its column-parallel
work and reduce-scatters its row-parallel exit back to the slice
(``collectives.gather_seq`` and ``scatter_seq``, in place of ``copy_to``
and ``all_sum``); with replicated heads the block's output is whole on
each rank, which keeps its slice. Token shift, the temporal conv and both
scans run on the gathered sequence. The embedding's vocab-parallel sum
becomes a reduce-scatter along the sequence; the final hidden state is
gathered whole with ``all_gather`` (the cross-entropy's backward already
sums its gradient over ``model``). A sequence that does not divide over
``model`` (a decode step's one token among them) raises ``ValueError``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (all_gather, all_sum,
                                                 copy_to, gather_seq,
                                                 mesh_collective,
                                                 scatter_seq)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ref import merge_lse
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.common import (P, Norm, add_params, gathered,
                                       init_tensor, mark_seq_partial,
                                       norm_template, padded_vocab,
                                       seq_ctx, seq_slice, stack_templates,
                                       torch_dtype)
from repro_torch.models.mlp import MLP, mlp_template
from repro_torch.models.moe import MoE, moe_template
from repro_torch.models.rglru import (RGLRU, rglru_apply,
                                      rglru_state_template, rglru_template)
from repro_torch.models.rwkv6 import (RWKVMix, rwkv_channel_mix,
                                      rwkv_state_template, rwkv_template,
                                      rwkv_time_mix)

INT32_MAX = 2 ** 31 - 1
ATTENTION_KINDS = ("attn", "local", "attn_dense")
RECURRENT_KINDS = ("rglru", "rwkv")
# recurrent states stay float32 in the cache
_F32_STATE_KEYS = ("h", "s", "conv", "x_prev_tm", "x_prev_cm")


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
# templates (the reference's, leaf for leaf)
# ---------------------------------------------------------------------------


def block_template(cfg, kind: str) -> dict:
    t = {"ln1": norm_template(cfg), "ln2": norm_template(cfg)}
    if kind in ("attn", "local", "attn_dense"):
        t["attn"] = attn.attn_template(cfg)
        if cfg.moe and kind == "attn":
            t["mlp"] = moe_template(cfg)
        else:
            t["mlp"] = mlp_template(cfg)
    elif kind == "rglru":
        t["lru"] = rglru_template(cfg)
        t["mlp"] = mlp_template(cfg)
    elif kind == "rwkv":
        t["mix"] = rwkv_template(cfg)
    else:
        raise ValueError(kind)
    return t


def embed_templates(cfg) -> dict:
    """The model's own leaves: ``embed`` and, unless tied, ``unembed``."""
    D, Vp = cfg.d_model, padded_vocab(cfg)
    t = {"embed": P((Vp, D), ("vocab", "embed"), "embed", 0.02)}
    if not cfg.tie_embeddings:
        t["unembed"] = P((D, Vp), ("embed", "vocab"))
    return t


def model_template(cfg) -> dict:
    own = embed_templates(cfg)
    t = {"embed": own["embed"], "final_norm": norm_template(cfg),
         "groups": {}}
    if not cfg.tie_embeddings:
        t["unembed"] = own["unembed"]
    for gi, (kinds, reps) in enumerate(layer_groups(cfg)):
        cyc = {f"b{i}": block_template(cfg, k) for i, k in enumerate(kinds)}
        t["groups"][f"g{gi}"] = stack_templates(cyc, reps) if reps > 1 else cyc
    return t


def block_cache_template(cfg, kind: str, batch: int, max_seq: int) -> dict:
    if kind in ("attn", "local", "attn_dense"):
        C = cache_capacity(cfg, kind, max_seq)
        Hkv, hd = cfg.n_kv_heads, cfg.hd
        return {
            "k": P((batch, C, Hkv, hd), ("batch", "kv_seq", "kv_heads", None), "zeros"),
            "v": P((batch, C, Hkv, hd), ("batch", "kv_seq", "kv_heads", None), "zeros"),
            "pos": P((batch, C), ("batch", "kv_seq"), "ones"),  # scaled below
        }
    if kind == "rglru":
        return rglru_state_template(cfg, batch)
    if kind == "rwkv":
        return rwkv_state_template(cfg, batch)
    raise ValueError(kind)


def cache_template(cfg, batch: int, max_seq: int) -> dict:
    t = {"groups": {}}
    for gi, (kinds, reps) in enumerate(layer_groups(cfg)):
        cyc = {f"b{i}": block_cache_template(cfg, k, batch, max_seq)
               for i, k in enumerate(kinds)}
        t["groups"][f"g{gi}"] = stack_templates(cyc, reps) if reps > 1 else cyc
    return t


# ---------------------------------------------------------------------------
# heads over the model axis
# ---------------------------------------------------------------------------


def _pad_group(cfg, ctx):
    """Padded-heads mode: extra query heads per kv group so the activation
    head count divides the model axis (params untouched; zero-padded at
    compute time — exact)."""
    if cfg.attn_sharding != "padded" or ctx is None:
        return 0
    m = ctx.axis_sizes.get("model", 1)
    if m <= 1 or cfg.n_heads % m == 0:
        return 0
    G = cfg.n_heads // cfg.n_kv_heads
    need = m // math.gcd(cfg.n_kv_heads, m)
    return -(-G // need) * need - G


class HeadShard:
    """Where one attention layer's heads and KV cache lie over the
    ``model`` axis of ``ctx`` (of size m > 1), in one of three cases:

    - ``kv_local``: m divides the KV heads. The rank holds its KV heads
      (weights and cache) and the query heads of their groups.
    - ``act`` without ``kv_local``: the query heads are split (m divides
      them, or they are zero-padded per KV group in ``"padded"`` mode)
      but the KV heads are not; the cache's sequence is split instead.
    - neither: the heads are replicated; the cache's sequence is split.

    In the first two the rank takes ``n`` query heads from ``j0`` (of
    the padded ``Hp``) and the output projection is row-parallel, summed
    over ``model``."""

    def __init__(self, cfg, ctx):
        m, r = ctx.size("model"), ctx.index("model")
        self.ctx = ctx
        self.kv_local = ctx.sharded("kv_heads")
        self.kv_seq = ctx.sharded("kv_seq")
        self.q_local = ctx.sharded("heads")     # wq holds the rank's heads
        self.act = self.kv_local or ctx.sharded("act_heads")
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.G = Hq // Hkv
        self.pad_g = 0 if self.q_local else _pad_group(cfg, ctx)
        self.Gp = self.G + self.pad_g
        self.n = Hkv * self.Gp // m if self.act else Hq
        self.j0 = r * self.n if self.act else 0
        self.kv_idx = None           # the KV heads of the rank's q heads
        if self.act and not self.kv_local:
            groups = [j // self.Gp for j in range(self.j0, self.j0 + self.n)]
            lo, hi = groups[0], groups[-1] + 1
            if all(groups.count(g) == self.n // (hi - lo)
                   for g in range(lo, hi)):
                self.kv_idx = slice(lo, hi)
            else:                    # one KV head per query head
                self.kv_idx = torch.tensor(groups)

    def pad(self, t, dim: int):
        """Zero-pad dim ``dim`` (query heads, Hq) to Hkv Gp by KV group."""
        if not self.pad_g:
            return t
        g = t.unflatten(dim, (t.shape[dim] // self.G, self.G))
        pads = [0, 0] * (g.ndim - dim - 2) + [0, self.pad_g]
        return torch.nn.functional.pad(g, pads).flatten(dim, dim + 1)

    def queries(self, q):
        """The rank's query heads of the projection's q (B,S,H,hd)."""
        if not self.act or self.q_local:
            return q
        return self.pad(q, 2).narrow(2, self.j0, self.n)

    def kv(self, t):
        """The KV heads (B,S,Hkv,hd) that the rank's query heads read."""
        return t if self.kv_idx is None else t[:, :, self.kv_idx]

    def out_weight(self, wo):
        """The rows of ``wo`` for the rank's query heads."""
        if not self.act or self.q_local:
            return wo
        return self.pad(wo, 0).narrow(0, self.j0, self.n)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class AttentionBlock(nn.Module):
    """Pre-norm attention + dense MLP, or MoE for an MoE config's
    ``attn`` kind, as ``_attention_block`` (kinds ``attn``, ``local``
    and ``attn_dense``); under ``ctx`` its heads lie as ``HeadShard``
    says."""

    def __init__(self, cfg, kind: str, *, device, dtype, ctx=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.kind = kind
        self.window = attention_window(cfg, kind)
        self.ln1 = Norm(cfg, ctx=ctx, **kw)
        self.ln2 = Norm(cfg, ctx=ctx, **kw)
        self.attn = attn.Attention(cfg, ctx=ctx, **kw)
        self.mlp = (MoE(cfg, ctx=ctx, **kw) if cfg.moe and kind == "attn"
                    else MLP(cfg, ctx=ctx, **kw))
        self.shard = (HeadShard(cfg, ctx) if ctx is not None
                      and ctx.size("model") > 1 else None)
        self.seq = seq_ctx(ctx)
        sh = self.shard
        if self.seq is not None:
            # leaves replicated over model whose output each rank cuts to
            # its slice (replicated heads) or to its heads
            names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if sh.act:
                names = ((() if sh.q_local else ("wq", "bq"))
                         + (() if sh.kv_local else ("wk", "wv", "bk", "bv")))
            mark_seq_partial(*(getattr(self.attn, n) for n in names
                               if hasattr(self.attn, n)))

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        cfg = self.cfg
        h = self.ln1(x)
        at = gathered(self.attn)
        sh = self.shard
        if self.seq is not None:
            # the rank's heads (or, replicated, every head) take the whole
            # sequence; each rank's gradient of it is one term
            q, k, v = attn.qkv_proj(at, gather_seq(h, self.seq), cfg,
                                    positions)
            if sh.act:
                q = sh.queries(q)
        elif sh is None or not sh.act:
            q, k, v = attn.qkv_proj(at, h, cfg, positions)
        else:
            # the rank's heads take h, replicated over model, through
            # copy_to; q, k or v computed whole enter through it instead
            hl = copy_to(h, sh.ctx)
            q, k, v = attn.qkv_proj(at, h, cfg, positions,
                                    xq=hl if sh.q_local else h,
                                    xkv=hl if sh.kv_local else h)
            if not sh.q_local:
                q = copy_to(q, sh.ctx)
            if not sh.kv_local:
                k, v = copy_to(k, sh.ctx), copy_to(v, sh.ctx)
            q = sh.queries(q)
        if mode == "decode":
            o = self._decode(q, k, v, positions, cache, t)
        else:
            kq, vq = (k, v) if sh is None else (sh.kv(k), sh.kv(v))
            if q.device.type == "cpu" and q.shape[1] > attn.BLOCKED_ABOVE:
                o = attn.blocked_attention(q, kq, vq, positions, positions,
                                           self.window)
            else:
                o = flash_attention(q, kq, vq, causal=True,
                                    window=self.window)
        if cache is not None and mode != "decode":
            _prefill_write(cache, k, v, positions, *self._ring(cache))
        if sh is None or not sh.act:
            y = attn.out_proj(at, o)
            x = x + (y if self.seq is None else seq_slice(y, self.seq))
        else:
            wo = at.wo if sh.q_local else copy_to(at.wo, sh.ctx)
            y = torch.einsum("bshk,hkd->bsd", o, sh.out_weight(wo))
            x = x + (all_sum(y, sh.ctx) if self.seq is None
                     else scatter_seq(y, self.seq))
        if isinstance(self.mlp, MoE):
            m, aux = self.mlp(self.ln2(x))
            return x + m, aux
        return x + self.mlp(self.ln2(x)), None

    def _ring(self, cache):
        """(first slot, capacity C) of the ring the rank's cache slots
        belong to: its slice of the sequence where ``kv_seq`` is split,
        else (0, its length)."""
        C = cache["k"].shape[1]
        if self.shard is None or not self.shard.kv_seq:
            return 0, C
        ctx = self.shard.ctx
        return ctx.index("model") * C, C * ctx.size("model")

    def _decode(self, q, k, v, positions, cache, t):
        """Write the token at slot ``t % C``, then attend to the cache.
        Where the rank holds a slice of the ring, it writes the token only
        if the slot is there, attends with every query head (gathered
        over ``model`` where they are split) to its slots, and the ranks'
        outputs merge by their log-sum-exp."""
        c0, C = self._ring(cache)
        slot = int(t) % C - c0
        q_pos = positions[:, 0].to(torch.int32).contiguous()
        if 0 <= slot < cache["k"].shape[1]:
            cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][:, slot] = q_pos
        B, _, Hq, hd = q.shape
        q = q.reshape(B, Hq, hd)
        sh = self.shard
        if sh is None or not sh.kv_seq:
            o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                 q_pos, window=self.window)
            return o.reshape(B, 1, Hq, hd)
        if sh.act:
            q = mesh_collective("gather", q, sh.ctx, dim=1)
        o, lse = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                  q_pos, window=self.window, return_lse=True)
        parts = mesh_collective(
            "gather", torch.cat([o.float(), lse[..., None]], -1)[None],
            sh.ctx, dim=0)
        o = merge_lse(parts[..., :hd], parts[..., hd]).to(o.dtype)
        if sh.act:
            o = o[:, sh.j0:sh.j0 + sh.n]
        return o.reshape(B, 1, o.shape[1], hd)


def _prefill_write(cache, k, v, positions, c0: int = 0, C: int = None
                   ) -> None:
    """Persist a prefill's KV in place. Slots [0, S) when S < C; else the
    last C tokens, rolled so that position p lands at slot p % C (the
    reference's ring convention). The cache holds slots [c0, c0 + its
    length) of a ring of C (by default its length: the whole ring)."""
    n = cache["k"].shape[1]
    C = n if C is None else C
    S = k.shape[1]
    if S >= C:
        sh = (S - C) % C
        for name, val in (("k", k), ("v", v), ("pos", positions)):
            ring = torch.roll(val[:, -C:], sh, dims=1)
            cache[name].copy_(ring if n == C else ring[:, c0:c0 + n])
    elif c0 < S:
        hi = min(c0 + n, S)
        cache["k"][:, :hi - c0] = k[:, c0:hi].to(cache["k"].dtype)
        cache["v"][:, :hi - c0] = v[:, c0:hi].to(cache["v"].dtype)
        cache["pos"][:, :hi - c0] = positions[:, c0:hi].to(torch.int32)


class RGLRUBlock(nn.Module):
    """Pre-norm RG-LRU + dense MLP, as ``_rglru_block`` (kind
    ``rglru``). The cache is the layer's recurrent state, written in
    place; positions, t and mode play no part."""

    kind = "rglru"

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg, ctx=ctx, **kw)
        self.lru = RGLRU(cfg, ctx=ctx, **kw)
        self.ln2 = Norm(cfg, ctx=ctx, **kw)
        self.mlp = MLP(cfg, ctx=ctx, **kw)

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        o, _ = rglru_apply(gathered(self.lru), self.ln1(x), cache)
        x = x + o
        return x + self.mlp(self.ln2(x)), None


class RWKVBlock(nn.Module):
    """Pre-norm RWKV6 time mix, then channel mix, as ``_rwkv_block``
    (kind ``rwkv``). The cache is the layer's recurrent state, written
    in place; positions, t and mode play no part."""

    kind = "rwkv"

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = Norm(cfg, ctx=ctx, **kw)
        self.mix = RWKVMix(cfg, ctx=ctx, **kw)
        self.ln2 = Norm(cfg, ctx=ctx, **kw)

    def forward(self, x, positions, cache=None, t=None, mode: str = "train"):
        mix = gathered(self.mix)
        o, _ = rwkv_time_mix(mix, self.ln1(x), self.cfg, cache)
        x = x + o
        o2, _ = rwkv_channel_mix(mix, self.ln2(x), self.cfg, cache)
        return x + o2, None


def make_block(cfg, kind: str, *, device, dtype, ctx=None) -> nn.Module:
    if kind == "rglru":
        return RGLRUBlock(cfg, device=device, dtype=dtype, ctx=ctx)
    if kind == "rwkv":
        return RWKVBlock(cfg, device=device, dtype=dtype, ctx=ctx)
    return AttentionBlock(cfg, kind, device=device, dtype=dtype, ctx=ctx)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class Transformer(nn.Module):
    """``embed`` (Vp, D), ``final_norm``, ``unembed`` (D, Vp) unless the
    embeddings are tied, and ``layers`` in global order; under ``ctx``
    each parameter is this rank's shard. Parameters are allocated
    uninitialized: use ``init_model`` or ``interop.model_from_reference``."""

    def __init__(self, cfg, device="cuda", dtype=None, ctx=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(device=dev, dtype=dt)
        self.cfg = cfg
        self.ctx = ctx
        own = embed_templates(cfg)
        add_params(self, {"embed": own.pop("embed")}, ctx, **kw)
        self.final_norm = Norm(cfg, ctx=ctx, **kw)
        add_params(self, own, ctx, **kw)           # unembed, if untied
        self.layers = nn.ModuleList(
            make_block(cfg, kind, ctx=ctx, **kw)
            for kind in cfg.layer_kinds())
        # the vocab rows or columns this rank holds, where they are split
        self.vocab_ctx = (ctx if ctx is not None and ctx.sharded("vocab")
                          else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg, generator: Optional[torch.Generator] = None,
               device="cuda", dtype=None, ctx=None) -> Transformer:
    """The model with weights drawn under the reference's init rules, in
    ``cfg.param_dtype`` unless ``dtype`` is given. As in the reference,
    a group of ``reps > 1`` layers draws each leaf once with its stacked
    ``(reps, ...)`` shape (so its fan-in counts the layer axis), then
    hands layer r its slice. ``generator`` defaults to seed 0 on the
    model's device. Under ``ctx`` every rank draws each whole leaf (the
    same draws as the unsharded model), keeps its shard and frees the
    rest before the next leaf, so no rank ever holds the whole model."""
    model = Transformer(cfg, device, dtype, ctx)
    if generator is None:
        generator = torch.Generator(model.device).manual_seed(0)

    def keep(p, val):
        p.copy_(val if ctx is None else ctx.local(val, p.axes))

    with torch.no_grad():
        for name in ("embed", "unembed"):
            if hasattr(model, name):
                _draw(getattr(model, name), generator, keep)
        for p in model.final_norm.parameters():
            _draw(p, generator, keep)
        for _, kinds, reps, idx in group_layers(cfg):
            for i in range(len(kinds)):
                blocks = [model.layers[row[i]] for row in idx]
                for name, p in blocks[0].named_parameters():
                    same = [b.get_parameter(name) for b in blocks]
                    shape = ((reps, *p.full_shape) if reps > 1
                             else p.full_shape)
                    val = init_tensor(shape, p.init, p.init_scale, generator,
                                      p.dtype)
                    for r, q in enumerate(same):
                        keep(q, val[r] if reps > 1 else val)
                    # freed before the next leaf is drawn: a stacked
                    # expert leaf is 16.6 GB in float32 at full width
                    del val
    return model


def _draw(p, generator, keep) -> None:
    keep(p, init_tensor(p.full_shape, p.init, p.init_scale, generator,
                        p.dtype))


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def cache_capacity(cfg, kind: str, max_seq: int) -> int:
    if kind == "local" or (cfg.attn_type == "swa" and cfg.window):
        return min(max_seq, cfg.window)
    return max_seq


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", ctx=None) -> list:
    """Empty cache, one dict per layer, the leaves of
    ``block_cache_template``. Attention layers: ``k``/``v`` (B, C, Hkv,
    hd) in ``dtype`` and ``pos`` (B, C) int32 filled with INT32_MAX, so
    masks exclude unfilled slots; C = min(max_seq, window) for
    local/SWA. Recurrent layers: their zeroed float32 state, as the
    reference's ``init_cache`` keeps it: ``h`` (B, R) and ``conv``
    (B, cw-1, R) for ``rglru``; ``s`` (B, H, hd, hd), ``x_prev_tm`` and
    ``x_prev_cm`` (B, D) for ``rwkv``. Under ``ctx`` each leaf is this
    rank's shard: its rows of the batch (``batch`` is the global batch),
    and its KV heads, ring slots, channels or wkv heads as the rules
    say."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    out = []
    for kind in cfg.layer_kinds():
        layer = {}
        for name, t in block_cache_template(cfg, kind, batch,
                                            max_seq).items():
            shape = (t.shape if ctx is None
                     else ctx.local_shape(t.shape, t.axes))
            if name == "pos":
                layer[name] = torch.full(shape, INT32_MAX, dtype=torch.int32,
                                         device=dev)
            else:
                layer[name] = torch.zeros(
                    shape, device=dev,
                    dtype=torch.float32 if name in _F32_STATE_KEYS else dt)
        out.append(layer)
    return out


# ---------------------------------------------------------------------------
# embedding / logits / forward
# ---------------------------------------------------------------------------


def embed_lookup(model: Transformer, tokens):
    """The token embeddings. Where the vocab is split over ``model``, each
    rank looks up the ids in its rows (zero elsewhere) and the ranks'
    rows are summed: exact, one term of each sum being non-zero. Under
    sequence parallelism the rank's slice of the sequence: the sum is a
    reduce-scatter along it."""
    embed = gathered(model).embed
    sp = seq_ctx(model.ctx)
    if model.vocab_ctx is None:
        out = torch.nn.functional.embedding(tokens.long(), embed)
        return out if sp is None else seq_slice(out, sp)
    ctx = model.vocab_ctx
    vloc = embed.shape[0]
    ids = tokens.long() - ctx.index("model") * vloc
    ok = (ids >= 0) & (ids < vloc)
    out = torch.nn.functional.embedding(ids.clamp(0, vloc - 1), embed)
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return all_sum(out, ctx) if sp is None else scatter_seq(out, sp)


def unembed_weight(model: Transformer):
    """(D, Vp) or, where the vocab is split, the rank's columns."""
    if model.cfg.tie_embeddings:
        return gathered(model).embed.t()
    return gathered(model).unembed


def logits_fn(model: Transformer, hidden):
    """Full logits (B,S,Vp) over the padded vocab: where the vocab is
    split over ``model``, the rank's columns gathered."""
    out = hidden @ unembed_weight(model)
    if model.vocab_ctx is None:
        return out
    return all_gather(out, model.vocab_ctx, dim=-1)


def forward(model: Transformer, *, tokens=None, embeds=None, positions,
            cache=None, t=None, mode: str = "train"):
    """Returns (hidden (B,S,D), cache, aux_loss), aux_loss the sum of the
    MoE layers' load-balance losses (zero without MoE). The cache, when
    given, is written in place and returned. Under sequence parallelism
    ``embeds`` may be whole or the rank's slice; the hidden state comes
    back whole."""
    dt = torch_dtype(model.cfg.dtype)
    sp = seq_ctx(model.ctx)
    S = positions.shape[1]
    if sp is not None and S % sp.size("model"):
        raise ValueError(f"sequence parallelism cuts the sequence over the "
                         f"model axis: length {S} does not divide over its "
                         f"{sp.size('model')} ranks")
    if embeds is not None:
        x = embeds.to(dt)
        if sp is not None and x.shape[1] == S:
            x = seq_slice(x, sp)
    else:
        x = embed_lookup(model, tokens).to(dt)
    x, aux = apply_layers(model, x, positions, 0, len(model.layers), cache,
                          t, mode)
    x = model.final_norm(x)
    return (x if sp is None else all_gather(x, sp, dim=1)), cache, aux


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
