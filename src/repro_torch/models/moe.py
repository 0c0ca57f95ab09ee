"""Mixture-of-Experts: softmax top-k routing, then capacity (default) or
sort-based ragged dispatch over the experts' SwiGLU FFNs, plus always-on
shared experts. Counterpart of ``repro/models/moe.py``.

Under a ``ShardCtx`` the reference's two ``shard_map`` modes run as local
shards with explicit sums over the ``model`` axis (``MoE``,
``moe_apply``): ``"expert"`` (each rank its E/m experts) and
``"tensor"`` (each rank its d_ff slice of every expert). The tokens and
routing weights, replicated over ``model``, enter the rank's experts
through ``collectives.copy_to``. Over the batch axes the reference has
two rules, and the port keeps both (measured on the reference, not read
from it):

- with ``model`` of more than one rank, its ``shard_map`` routes each
  data shard alone: the capacity comes from the shard's tokens, the aux
  loss is the shard's, and the value the step reports is data shard 0's
  (``collectives.first_of``), while each shard's gradient is its own aux
  over the shard count;
- with ``model`` of one rank there is no ``shard_map``: GSPMD routes the
  global batch, so the aux loss is taken over every token (the routing
  probabilities and counts summed over the batch axes), the capacity
  comes from the global token count, and an assignment's place in its
  expert counts the assignments of the data shards before it.

Three rules keep the port on the reference's answers and bit for bit
repeatable on the card:

- Assignments are ranked within their expert by a *stable* sort
  (``jnp.argsort`` is stable; ``torch.argsort`` is only when told), so
  the same assignments overflow the capacity and drop as in the
  reference.
- No atomics, forward or backward: the combine gathers each
  assignment's row and adds a token's k rows in order, in the output
  dtype; the reference's ``out.at[t].add`` is a scatter-add whose order
  a CUDA ``index_add_`` would vary from run to run. The capacity
  dispatch gathers each token into its k slots (``_Dispatch``), and
  autograd's backward of that gather would add a token's k slot
  gradients by an accumulating ``index_put_``, in any order on CUDA; its
  backward is the mirror of the combine instead: each token gathers its
  kept slots' gradients and adds them in order j = 0..k-1. So a training
  step, and a run resumed from a checkpoint, repeat bit for bit. The
  ragged path (``_dispatch_ffn``, not the default) keeps autograd's
  backward of its gather and scatter.
- Router logits are float32 products with TF32 off, since a logit that
  moves changes the top-k experts.

Under sequence parallelism (``seq`` on ``model``) the layer takes the
rank's slice of the sequence and gathers it whole (``gather_seq``), so
the routing, the capacity and the aux loss are those of the same tokens
as without it; the tokens and routing weights then enter the rank's
experts without ``copy_to`` (the gather's reduce-scatter sums their
gradient), the routed and shared partial sums are reduce-scattered back
to the slice (``scatter_seq``), the router is marked ``seq_partial``,
and the aux loss, which every rank takes on the same tokens, passes
1/m of its gradient on each. (The reference's ``shard_map`` cuts the
sequence as well and routes each slice alone, then sums the ranks'
outputs for different tokens: its step under sequence parallelism moves
by 3 % of the gradient's norm against its own step without a mesh, and
the port does not follow it there.)

The expert products are plain batched matrix products, as the
reference's ``jnp.einsum``/``jax.lax.ragged_dot`` are: no Pallas kernel
of the reference runs here, so none of the port does.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import (all_sum, copy_to,
                                                 first_of, gather_seq,
                                                 mesh_collective,
                                                 scatter_seq)
from repro_torch.models.common import (P, add_params, gathered,
                                       mark_seq_partial, seq_ctx,
                                       torch_dtype)
from repro_torch.models.mlp import MLP, mlp_apply, mlp_template


def moe_template(cfg):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ex_axes = ("experts", "embed", "expert_ff")
    t = {
        "router": P((D, E), ("embed", None), "small"),
        "wg": P((E, D, Fd), ex_axes),
        "wu": P((E, D, Fd), ex_axes),
        "wd": P((E, Fd, D), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        t["shared"] = mlp_template(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts)
    return t


class MoE(nn.Module):
    """``router`` (D, E), ``wg``/``wu`` (E, D, F), ``wd`` (E, F, D), and
    ``shared`` (an ``MLP``) when the config has shared experts. Under
    ``ctx`` (the reference's ``shard_map`` modes): in ``"expert"`` mode
    (``experts`` on ``model``) this rank's E/m experts; in ``"tensor"``
    mode (``expert_ff`` on ``model``) this rank's F/m columns of every
    expert."""

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        self.cfg = cfg
        tmpl = moe_template(cfg)
        tmpl.pop("shared", None)
        add_params(self, tmpl, ctx, device=device, dtype=dtype)
        self.mode, self.ctx = None, None
        if ctx is not None and ctx.sharded("experts"):
            self.mode, self.ctx = "expert", ctx
        elif ctx is not None and ctx.sharded("expert_ff"):
            self.mode, self.ctx = "tensor", ctx
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts,
                              device=device, dtype=dtype, ctx=ctx)
        self.seq = seq_ctx(ctx) if self.mode is not None else None
        if self.seq is not None:
            mark_seq_partial(self.router)
        # the batch axes: routed as one batch (``batch_ctx``, model of one
        # rank) or shard by shard with shard 0's aux reported (``data_ctx``)
        self.batch_ctx, self.data_ctx = None, None
        if ctx is not None and any(ctx.size(a) > 1 for a in ctx.batch_axes):
            if self.mode is None:
                self.batch_ctx = ctx
            else:
                self.data_ctx = ctx

    def forward(self, x):
        return moe_apply(gathered(self), x, self.cfg)


@contextlib.contextmanager
def no_tf32():
    """cuBLAS float32 products at full precision inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _counts(ids, n: int):
    """How many of the integer ``ids`` equal each of 0..n-1. A compare
    and a sum: ``torch.bincount`` reads the largest id back to the host
    on CUDA (a synchronisation a layer), and a scatter-add is atomic."""
    return (ids.reshape(-1, 1) == torch.arange(n, device=ids.device)).sum(0)


def _route(xt, router_w, cfg, batch_ctx=None):
    """softmax -> top-k -> renormalize. Returns (weights, ids, aux):
    (T, k) float32, (T, k) int64, and the Switch-style load-balance loss
    E * sum_e f_e p_e, f_e the share of top-k assignments to e. Under
    ``batch_ctx`` the shares and mean probabilities are over the tokens
    of every batch shard."""
    T, k, E = xt.shape[0], cfg.top_k, cfg.n_experts
    with no_tf32():
        logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    if batch_ctx is None:
        pe = probs.mean(dim=0)
        fe = _counts(topi, E).float() / (T * k)
    else:
        axes = batch_ctx.batch_axes
        Tg = T * _shards(batch_ctx)
        pe = all_sum(probs.sum(dim=0), batch_ctx, axes) / Tg
        fe = all_sum(_counts(topi, E), batch_ctx, axes).float() / (Tg * k)
    return topw, topi, E * torch.sum(fe * pe)


def _shards(ctx) -> int:
    """How many shards the batch is split into."""
    n = 1
    for a in ctx.batch_axes:
        n *= ctx.size(a)
    return n


def _earlier(counts, ctx):
    """Each expert's assignments on the batch shards before this rank's
    (rank order over the batch axes, row-major)."""
    rows = counts[None]
    for a in reversed(ctx.batch_axes):
        rows = mesh_collective("gather", rows, ctx, a, dim=0)
    idx = ctx.shards(ctx.rules.get("batch"))[0]
    return rows[:idx].sum(dim=0)


def _assignments(topi, topw, k, e_lo: int, e_n: int):
    """The flat (A = T k) assignments in token order: expert bin (e_n
    for an expert outside [e_lo, e_lo + e_n)), weight, token."""
    A = topi.numel()
    local_e = topi.reshape(A) - e_lo
    is_local = (local_e >= 0) & (local_e < e_n)
    eid = torch.where(is_local, local_e, e_n)
    flat_t = torch.arange(A, device=topi.device) // k
    return eid, topw.reshape(A), flat_t, is_local


def _sum_in_order(rows, k: int):
    """out[t] = sum_j rows[t k + j], added in order j = 0..k-1."""
    g = rows.reshape(rows.shape[0] // k, k, -1)
    out = g[:, 0]
    for j in range(1, k):
        out = out + g[:, j]
    return out


def _combine(rows, w, T: int, k: int):
    """out[t] = sum_j rows[t k + j] w[t k + j], added in order j = 0..k-1
    in the rows' dtype (the reference's scatter-add, without atomics);
    the weights are cast to that dtype before they multiply."""
    return _sum_in_order(rows * w[:, None].to(rows.dtype), k)


class _Dispatch(torch.autograd.Function):
    """The capacity buffer xb[e, c] = xt[src_t[e, c]] where ``filled``,
    else 0, with a backward that adds no two rows at once: dxt[t] =
    sum_j keep[t k + j] dxb[slot[t k + j]], in order j = 0..k-1 (each
    kept assignment fills exactly its slot ``slot = e C + pos``)."""

    @staticmethod
    def forward(ctx, xt, src_t, filled, keep, slot, k):
        ctx.save_for_backward(keep, slot)
        ctx.k = k
        return torch.where(filled[..., None], xt[src_t], 0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dxb):
        keep, slot = ctx.saved_tensors
        rows = dxb.reshape(-1, dxb.shape[-1])[slot]
        rows = torch.where(keep[:, None], rows, 0)
        return _sum_in_order(rows, ctx.k), None, None, None, None, None


def _expert_ffn(x, wg, wu, wd, mm):
    """SwiGLU over each expert's rows, with the product ``mm``."""
    act = (F.silu(mm(x, wg)) * mm(x, wu)).to(x.dtype)
    return mm(act, wd)


def ragged_dot(x, w, sizes):
    """``jax.lax.ragged_dot``: rows [o_e, o_e + sizes[e]) of x (m, K)
    times w[e] (K, N), o_e the sum of the sizes before e; rows past the
    last group are zero. Reads the group sizes on the host."""
    out = x.new_zeros(x.shape[0], w.shape[-1])
    lo = 0
    for e, n in enumerate(sizes.tolist()):
        if n:
            out[lo:lo + n] = x[lo:lo + n] @ w[e]
        lo += n
    return out


def _dispatch_ffn(xt, topw, topi, wg, wu, wd, cfg, e_lo: int, e_n: int,
                  cap: int):
    """Sort-based grouped FFN over the assignments routed to experts
    [e_lo, e_lo + e_n): sorted by expert (stably), truncated to ``cap``
    rows, run through ``ragged_dot``. xt: (T, D) -> (T, D)."""
    T, _ = xt.shape
    k = cfg.top_k
    eid, flat_w, flat_t, _ = _assignments(topi, topw, k, e_lo, e_n)
    A = eid.numel()
    order = torch.argsort(eid, stable=True)[:min(cap, A)]
    sel_e = eid[order]
    sel_w = torch.where(sel_e < e_n, flat_w[order], 0.0)
    counts = _counts(sel_e, e_n)
    cum = torch.clamp(torch.cumsum(counts, 0), max=order.numel())
    sizes = torch.diff(cum, prepend=cum.new_zeros(1))
    down = _expert_ffn(xt[flat_t[order]], wg, wu, wd,
                       lambda a, w: ragged_dot(a, w, sizes))
    # back to assignment order (each assignment once: no duplicates),
    # then the in-order combine; unselected assignments add zero
    rows = down.new_zeros(A, down.shape[-1])
    rows[order] = down
    w = torch.zeros(A, dtype=sel_w.dtype, device=sel_w.device)
    w[order] = sel_w
    return _combine(rows, w, T, k)


def _dispatch_ffn_capacity(xt, topw, topi, wg, wu, wd, cfg, e_lo: int,
                           e_n: int, cap_per_expert: int, before=None):
    """GShard-style fixed-capacity dispatch: each expert's first C
    assignments (in token order) fill a dense (E_loc, C, D) buffer, the
    expert products are batched matmuls, and each assignment gathers its
    row back. Overflow beyond C drops. xt: (T, D) -> (T, D). ``before``
    (E_loc,): assignments to each expert that come before these tokens
    (other batch shards'), taking their places first."""
    T, D = xt.shape
    k = cfg.top_k
    C = cap_per_expert
    eid, flat_w, flat_t, is_local = _assignments(topi, topw, k, e_lo, e_n)
    A = eid.numel()
    # rank of each assignment within its expert (stable over A order)
    order = torch.argsort(eid, stable=True)
    ranked = torch.empty_like(order)
    ranked[order] = torch.arange(A, device=xt.device)
    counts = _counts(eid, e_n + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = ranked - starts[eid]
    # slot (e, c) holds the assignment of rank c in expert e, if any
    c = torch.arange(C, device=xt.device)
    src = starts[:e_n, None] + c
    if before is None:
        keep = is_local & (pos < C)
        filled = c < counts[:e_n, None]
    else:
        room = C - before
        keep = is_local & (pos < torch.cat([room, room.new_zeros(1)])[eid])
        filled = (c < counts[:e_n, None]) & (c < room[:, None])
    take = order[src.clamp(max=A - 1)]
    slot = (eid * C + pos).clamp(0, e_n * C - 1)
    xb = _Dispatch.apply(xt, flat_t[take], filled, keep, slot, k)  # (E,C,D)
    down = _expert_ffn(xb, wg, wu, wd, torch.bmm).reshape(e_n * C, D)
    rows = torch.where(keep[:, None], down[slot], 0)
    return _combine(rows, flat_w, T, k)


def _maybe_quant_experts(cfg, *ws, ctx=None):
    """bf16 -> (f8e4m3, per-expert scale) casts (identity for bf16). The
    scale is taken over each whole expert: under ``ctx`` (``"tensor"``
    mode, the rank holding a slice of each expert) the amax is the
    maximum over ``model``."""
    if not cfg.moe_weight_dtype.startswith("float8"):
        return [(w, None) for w in ws]
    out = []
    for w in ws:
        amax = w.float().abs().amax(dim=(1, 2), keepdim=True)
        amax = mesh_collective("max", amax, ctx)
        # tensor / tensor: ``448.0 / t`` is t.reciprocal() * 448 in torch,
        # which rounds twice and misses the reference's scale by an ulp
        scale = torch.full_like(amax, 448.0) / torch.clamp(amax, min=1e-9)
        wq = (w.float() * scale).to(torch.float8_e4m3fn)
        out.append((wq, torch.reciprocal(scale)))
    return out


def _dequant(wq, scale, dtype):
    if scale is None:
        return wq
    return (wq.float() * scale).to(dtype)


# the least capacity of an expert in the capacity dispatch
MIN_CAPACITY = 4


def moe_apply(p: MoE, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar). Capacity per
    expert max(T k cf / E, MIN_CAPACITY), T the rank's tokens; the ragged path keeps
    every assignment (T k rows, at least 8), or T k cf / m rows (at least
    8) in ``"expert"`` mode over m ranks. In ``"expert"`` mode the rank
    runs the assignments routed to its experts [e_lo, e_lo + E/m) and
    the load-balance loss is averaged over ``model``; in ``"tensor"``
    mode every assignment runs against the rank's d_ff slice. Either
    way the routed and shared experts' partial sums are added over
    ``model`` in one collective."""
    x_in = x
    if p.seq is not None:
        x = gather_seq(x, p.seq)
    D = x.shape[-1]
    dt = torch_dtype(cfg.dtype)
    wg, wu, wd = (_dequant(q, s, dt) for q, s in _maybe_quant_experts(
        cfg, p.wg, p.wu, p.wd,
        ctx=p.ctx if p.mode == "tensor" else None))
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    topw, topi, aux = _route(xt, p.router, cfg, p.batch_ctx)
    e_lo, e_n, m = 0, cfg.n_experts, 1
    if p.mode == "expert":
        m = p.ctx.size("model")
        e_n = cfg.n_experts // m
        e_lo = p.ctx.index("model") * e_n
    # the tokens and weights enter the rank's experts (a no-op off a mesh)
    xe, we = ((xt, topw) if p.seq is not None
              else (copy_to(xt, p.ctx), copy_to(topw, p.ctx)))
    if cfg.moe_dispatch == "capacity":
        Tc, before = T, None
        if p.batch_ctx is not None:
            Tc = T * _shards(p.batch_ctx)
            before = _earlier(_counts(topi, cfg.n_experts), p.batch_ctx)
        cap_e = max(int(Tc * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts), MIN_CAPACITY)
        kw = {} if before is None else dict(before=before)
        out = _dispatch_ffn_capacity(xe, we, topi, wg, wu, wd, cfg, e_lo,
                                     e_n, cap_e, **kw)
    else:
        cap = (int(T * cfg.top_k * cfg.capacity_factor / m) if m > 1
               else T * cfg.top_k)
        out = _dispatch_ffn(xe, we, topi, wg, wu, wd, cfg, e_lo, e_n,
                            max(cap, 8))
    out = out.reshape(x.shape)
    if p.mode is None:
        if cfg.n_shared_experts:
            out = out + mlp_apply(p.shared, x)
        return out, aux
    # shared experts split over ``model`` join the routed partial sums;
    # whole ones (d_ff not divisible) are added after the sum
    split = cfg.n_shared_experts and p.shared.ctx is not None
    if split:
        out = out + mlp_apply(p.shared, x, reduce=False)
    out = all_sum(out, p.ctx) if p.seq is None else scatter_seq(out, p.seq)
    if split and not p.shared.gated:
        out = out + p.shared.bd.to(x.dtype)
    elif cfg.n_shared_experts and not split:
        out = out + mlp_apply(p.shared, x_in)
    if p.mode == "expert":
        # the reference's pmean of an aux every rank computed alike: the
        # same bits, and the gradient of the rank's own
        mean = mesh_collective("mean", aux.detach(), p.ctx)
        aux = aux + (mean - aux.detach()) if aux.requires_grad else mean
    if p.seq is not None and aux.requires_grad:
        # every rank took it on the same tokens: each passes 1/m
        aux = aux.detach() + (aux - aux.detach()) / p.seq.size("model")
    if p.data_ctx is not None:
        aux = first_of(aux, p.data_ctx, p.data_ctx.batch_axes)
    return out, aux
