"""Optimizers: AdamW (float32 moments) and factored Adafactor.
Counterpart of ``repro/train/optimizer.py``.

Trees are nested dicts of tensors (``repro_torch.tree``), visited in the
reference's leaf order. The arithmetic is the reference's, in float32
throughout, the schedule and the bias corrections included: JAX computes
``step / warmup``, ``b1 ** t`` and the cosine in float32, so they are
float32 tensors on the parameters' device here, Python numbers entering
only as float32 scalars (Python's float64 would move the learning rate
and the update in their last bits), and the step count is a device
int32, so a step reads nothing back to the host.

``update(grads, state, params)`` returns ``(params, state, metrics)`` as
the reference's does, but writes the new parameters, moments and step
into the tensors it was given, leaf by leaf: at Qwen2-1.5B the
parameters and AdamW's moments are 15.4 GB, and new trees beside the old
would double that. The global-norm clip is applied the same way: the
norm is taken over the tree, then each leaf is cast to float32 and
scaled inside the update's loop, one leaf at a time, the reference's
``g.astype(float32) * scale`` element for element. No float32 copy of
the gradient tree exists (at Qwen1.5-MoE-A2.7B's 14.3 B parameters it
would be 57.3 GB); ``clip_by_global_norm`` stays for the reference's
API.

Under a ``ShardCtx`` (``update(..., ctx=ctx)``; the parameters are the
rank's shards, each carrying its logical ``axes``) every statistic is
taken over the whole leaf, as the reference's jit takes it over its
global arrays: the clip's global norm sums each rank's squares over the
mesh axes its leaf is split on (a replicated leaf counts once), and
Adafactor's row and column means, the mean of ``vr`` and the RMS of the
update are each a local sum, summed over the split axes, over the full
count. The state is the rank's shard of each leaf's state, so it lies
as ``opt_spec_tree`` says. Without a ctx the arithmetic is unchanged.

``Optimizer.state_template`` maps a parameter template tree
(``models.transformer.model_template``, ``P`` leaves in the reference's
stacked layout) to the state's template, as the reference's: AdamW's
``m`` and ``v`` mirror it; Adafactor factors each leaf of two or more
dims into ``vr`` (all but the last dim) and ``vc`` (all but the
second-to-last), so a stack of vectors (reps, D) gets ``vr`` (reps,) and
``vc`` (D,); ``step`` is a scalar. ``opt_spec_tree`` maps it to specs.
The templates are host data, never tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.distributed.collectives import mesh_collective
from repro_torch.models.common import P
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state, m)
    state_template: Callable = None   # param template -> state template


def _map_p(fn, tmpl):
    if isinstance(tmpl, dict):
        return {k: _map_p(fn, v) for k, v in tmpl.items()}
    return fn(tmpl)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up, then a cosine to 0 at ``total``; ``step``
    an int tensor (or int), the result a float32 tensor."""
    def lr(step):
        s = torch.as_tensor(step).to(F32)
        w = torch.clamp(s / float(max(warmup, 1)), max=1.0)
        prog = torch.clamp((s - float(warmup))
                           / float(max(total - warmup, 1)), 0.0, 1.0)
        return base_lr * w * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return lr


def _sum_over(x, ctx, axes):
    for a in axes:
        x = mesh_collective("sum", x, ctx, a)
    return x


def _full_count(x, ctx, axes) -> int:
    n = x.numel()
    for a in axes:
        n *= ctx.size(a)
    return n


def _mean(x, dim, ctx=None, axes=()):
    """``x.mean(dim)`` of the whole leaf, ``dim`` split over ``axes``."""
    if not axes:
        return x.mean(dim=dim)
    n = x.shape[dim]
    for a in axes:
        n *= ctx.size(a)
    return _sum_over(x.sum(dim=dim), ctx, axes) / n


def _rms(u, ctx=None, axes=()):
    """sqrt(mean(u^2) + 1e-12) over the whole leaf, split over ``axes``."""
    if not axes:
        return torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
    sq = _sum_over(torch.sum(torch.square(u)), ctx, axes)
    return torch.sqrt(sq / _full_count(u, ctx, axes) + 1e-12)


def global_norm(tree, ctx=None, params=None):
    """The norm of every leaf together; under ``ctx`` each rank's squares
    summed over the mesh axes its leaf (``params``' leaf's ``axes``) is
    split on."""
    if ctx is None:
        total = 0
        for x in tree_leaves(tree):
            total = total + torch.sum(torch.square(x.float()))
        return torch.sqrt(total)
    by_axes = {}
    for x, p in zip(tree_leaves(tree), tree_leaves(params)):
        key = ctx.split_axes(p.axes)
        by_axes[key] = (by_axes.get(key, 0)
                        + torch.sum(torch.square(x.float())))
    total = 0
    for key in sorted(by_axes):
        total = total + _sum_over(by_axes[key], ctx, key)
    return torch.sqrt(total)


def clip_scale(grads, max_norm, ctx=None, params=None):
    """(scale, global norm): ``g.float() * scale`` is a leaf clipped."""
    gn = global_norm(grads, ctx, params)
    # a tensor over a tensor: ``max_norm / t`` is ``t.reciprocal() *
    # max_norm`` in torch, which rounds twice
    scale = torch.clamp(torch.full_like(gn, max_norm)
                        / torch.clamp(gn, min=1e-9), max=1.0)
    return scale, gn


def clip_by_global_norm(grads, max_norm):
    scale, gn = clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        def z():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params)
        dev = tree_leaves(params)[0].device
        return dict(m=z(), v=z(),
                    step=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(grads, state, params, ctx=None):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, max_grad_norm, ctx, params)
        t = step.to(F32)
        lr = lr_fn(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for p, m_, v_, g in zip(tree_leaves(params), tree_leaves(state["m"]),
                                tree_leaves(state["v"]), tree_leaves(grads)):
            g = g.float() * scale
            m_.copy_(b1 * m_ + (1 - b1) * g)
            v_.copy_(b2 * v_ + (1 - b2) * g * g)
            pf = p.float()
            u = (m_ / c1) / (torch.sqrt(v_ / c2) + eps) + weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
        state["step"].copy_(step)
        return params, state, dict(gnorm=gnorm, lr=lr)

    def state_template(tmpl):
        def as_p(t):
            return P(t.shape, t.axes, "zeros")
        return dict(m=_map_p(as_p, tmpl), v=_map_p(as_p, tmpl),
                    step=P((), (), "zeros"))

    return Optimizer(init, update, state_template)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment by default)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def _leaf_state(shape, reps: int, device) -> dict:
    """The zero state of a leaf that the reference stacks ``reps`` deep
    (one layer's slice; ``reps`` 1: a leaf of its own): the reference's
    state of the ``(reps, *shape)`` leaf, cut to the slice. A stacked
    vector's column moment ``vc`` spans the layers; each slice holds a
    copy."""
    z = dict(dtype=F32, device=device)
    shape = tuple(shape)
    if not _factored((reps, *shape) if reps > 1 else shape):
        return dict(v=torch.zeros(shape, **z))
    if reps > 1 and len(shape) == 1:
        return dict(vr=torch.zeros((), **z), vc=torch.zeros(shape, **z))
    return dict(vr=torch.zeros(shape[:-1], **z),
                vc=torch.zeros(shape[:-2] + shape[-1:], **z))


def _moments(g, s, beta, eps, ctx=None, da=None):
    """(u, new state): the reference's second moment of the whole leaf
    ``g`` (float32) from its state ``s``, and g over its square root.
    ``da``: per dim of ``g``, the mesh axes of ``ctx`` it is split over
    (None: whole)."""
    g2 = torch.square(g) + eps
    if _factored(g.shape):
        ra, ca = (da[-1], da[-2]) if da else ((), ())
        ns = dict(vr=beta * s["vr"] + (1 - beta) * _mean(g2, -1, ctx, ra),
                  vc=beta * s["vc"] + (1 - beta) * _mean(g2, -2, ctx, ca))
        return _over_factored(g, ns, eps, ctx, da), ns
    ns = dict(v=beta * s["v"] + (1 - beta) * g2)
    return g * torch.rsqrt(ns["v"] + eps), ns


def _over_factored(g, s, eps, ctx=None, da=None):
    vr, vc = s["vr"], s["vc"]
    vr_mean = _mean(vr, -1, ctx, da[-2] if da else ())
    denom = (vr[..., None] * vc[..., None, :]
             / torch.clamp(vr_mean[..., None, None], min=eps))
    return g * torch.rsqrt(denom + eps)


def _write(state: dict, new: dict) -> None:
    for k, v in new.items():
        state[k].copy_(v)


def adafactor(lr_fn, eps: float = 1e-30, clip_thresh: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0, stacks=()) -> Optimizer:
    """The reference's Adafactor. ``stacks`` lists the leaves that the
    reference holds as one stacked leaf (its scanned layers), each as a
    tuple of dotted leaf names in layer order (``trainer.stacked_leaves``
    of a model): the update treats each stack as that one leaf. Its
    moments are a slice's own where the slice is a matrix or more, but
    for a stack of vectors (norms, biases) the column moment spans the
    layers, and the RMS clip of the update always spans the stack. A
    stack of matrices is walked twice, the moments and the sum of u^2
    first, then u again from them, so no float32 copy of the stack
    exists (Qwen1.5-MoE-A2.7B's 24 expert leaves are 16.6 GB in
    float32)."""
    reps_of = {name: len(names) for names in stacks for name in names}

    def init(params):
        leaves = tree_leaves(params)
        states = [_leaf_state(p.shape, reps_of.get(".".join(k), 1), p.device)
                  for p, k in zip(leaves, _leaf_paths(params))]
        return dict(v=_like(params, iter(states)),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device))

    @torch.no_grad()
    def update(grads, state, params, ctx=None):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, max_grad_norm, ctx, params)
        t = step.to(F32)
        beta = 1.0 - torch.pow(t, -decay)
        lr = lr_fn(step)
        paths = _leaf_paths(params)
        gs, ps = tree_leaves(grads), tree_leaves(params)
        ss = [_get(state["v"], k) for k in paths]

        def da(i, stacked=False):
            """Per dim, the mesh axes leaf i (stacked: with its layers
            dim first) is split over; None off a mesh."""
            if ctx is None:
                return None
            d = ctx.dim_axes(ps[i].axes)
            return ((),) + d if stacked else d

        def split(i):
            """The mesh axes leaf i is split over."""
            return () if ctx is None else ctx.split_axes(ps[i].axes)

        def g32(i):
            return gs[i].float() * scale

        def apply(i, u, rms_u):
            # update clipping by RMS (Adafactor's d = 1.0 rule)
            u = u / torch.clamp(rms_u / clip_thresh, min=1.0)
            pf = ps[i].float()
            ps[i].copy_((pf - lr * (u + weight_decay * pf)).to(ps[i].dtype))

        for group in _groups(paths, stacks):
            if len(group) == 1:
                (i,) = group
                u, ns = _moments(g32(i), ss[i], beta, eps, ctx, da(i))
                _write(ss[i], ns)
                apply(i, u, _rms(u, ctx, split(i)))
            elif ps[group[0]].dim() >= 2:
                sq = 0
                for i in group:
                    u, ns = _moments(g32(i), ss[i], beta, eps, ctx, da(i))
                    _write(ss[i], ns)
                    sq = sq + torch.sum(torch.square(u))
                del u
                axes = split(group[0])
                n = sum(_full_count(ps[i], ctx, axes) for i in group)
                rms_u = torch.sqrt(_sum_over(sq, ctx, axes) / n + 1e-12)
                for i in group:
                    apply(i, _over_factored(g32(i), ss[i], eps, ctx, da(i)),
                          rms_u)
            else:
                s0 = ss[group[0]]
                stacked = ({k: torch.stack([ss[i][k] for i in group])
                            for k in s0} if "v" in s0 else
                           dict(vr=torch.stack([ss[i]["vr"] for i in group]),
                                vc=s0["vc"]))
                sda = da(group[0], stacked=True)
                u, ns = _moments(torch.stack([g32(i) for i in group]),
                                 stacked, beta, eps, ctx, sda)
                rms_u = _rms(u, ctx, split(group[0]))
                for r, i in enumerate(group):
                    _write(ss[i], {k: v if k == "vc" else v[r]
                                   for k, v in ns.items()})
                    apply(i, u[r], rms_u)
        state["step"].copy_(step)
        return params, state, dict(gnorm=gnorm, lr=lr)

    def state_template(tmpl):
        def per_leaf(tp):
            if _factored(tp.shape):
                return dict(vr=P(tp.shape[:-1], tp.axes[:-1], "zeros"),
                            vc=P(tp.shape[:-2] + tp.shape[-1:],
                                 tp.axes[:-2] + tp.axes[-1:], "zeros"))
            return dict(v=P(tp.shape, tp.axes, "zeros"))
        return dict(v=_map_p(per_leaf, tmpl), step=P((), (), "zeros"))

    return Optimizer(init, update, state_template)


def opt_spec_tree(opt: Optimizer, param_template, ctx):
    """The spec tree of the optimizer state (``sharding.spec_tree``)."""
    from repro_torch.distributed.sharding import spec_tree
    return spec_tree(opt.state_template(param_template), ctx)


def _groups(paths, stacks):
    """Leaf indices, a list for each of the reference's leaves: each
    stack in layer order, every other leaf alone; in the order of each
    group's first leaf in ``paths``."""
    at = {".".join(k): i for i, k in enumerate(paths)}
    group_of = {}
    for names in stacks:
        idx = [at[n] for n in names]
        for i in idx:
            group_of[i] = idx
    return [group_of.get(i, [i]) for i in range(len(paths))
            if min(group_of.get(i, [i])) == i]


def _like(tree, leaves):
    """``tree``'s structure holding the next of ``leaves`` at each leaf,
    in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _leaf_paths(tree, prefix=()):
    """Key paths of the leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [path for k in sorted(tree)
                for path in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
