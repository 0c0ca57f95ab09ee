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
API. ``state_template`` and ``opt_spec_tree`` build ``PartitionSpec``
trees and wait for the mesh tooling.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params) -> (params, state, m)


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


def global_norm(tree):
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_scale(grads, max_norm):
    """(scale, global norm): ``g.float() * scale`` is a leaf clipped."""
    gn = global_norm(grads)
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
    def update(grads, state, params):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, max_grad_norm)
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

    return Optimizer(init, update)


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


def _moments(g, s, beta, eps):
    """(u, new state): the reference's second moment of the whole leaf
    ``g`` (float32) from its state ``s``, and g over its square root."""
    g2 = torch.square(g) + eps
    if _factored(g.shape):
        ns = dict(vr=beta * s["vr"] + (1 - beta) * g2.mean(dim=-1),
                  vc=beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
        return _over_factored(g, ns, eps), ns
    ns = dict(v=beta * s["v"] + (1 - beta) * g2)
    return g * torch.rsqrt(ns["v"] + eps), ns


def _over_factored(g, s, eps):
    vr, vc = s["vr"], s["vc"]
    denom = (vr[..., None] * vc[..., None, :]
             / torch.clamp(vr.mean(dim=-1)[..., None, None], min=eps))
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
    def update(grads, state, params):
        step = state["step"] + 1
        scale, gnorm = clip_scale(grads, max_grad_norm)
        t = step.to(F32)
        beta = 1.0 - torch.pow(t, -decay)
        lr = lr_fn(step)
        paths = _leaf_paths(params)
        gs, ps = tree_leaves(grads), tree_leaves(params)
        ss = [_get(state["v"], k) for k in paths]

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
                u, ns = _moments(g32(i), ss[i], beta, eps)
                _write(ss[i], ns)
                apply(i, u, torch.sqrt(torch.mean(torch.square(u)) + 1e-12))
            elif ps[group[0]].dim() >= 2:
                sq = 0
                for i in group:
                    u, ns = _moments(g32(i), ss[i], beta, eps)
                    _write(ss[i], ns)
                    sq = sq + torch.sum(torch.square(u))
                del u
                n = sum(ps[i].numel() for i in group)
                rms_u = torch.sqrt(sq / n + 1e-12)
                for i in group:
                    apply(i, _over_factored(g32(i), ss[i], eps), rms_u)
            else:
                s0 = ss[group[0]]
                stacked = ({k: torch.stack([ss[i][k] for i in group])
                            for k in s0} if "v" in s0 else
                           dict(vr=torch.stack([ss[i]["vr"] for i in group]),
                                vc=s0["vc"]))
                u, ns = _moments(torch.stack([g32(i) for i in group]),
                                 stacked, beta, eps)
                rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                for r, i in enumerate(group):
                    _write(ss[i], {k: v if k == "vc" else v[r]
                                   for k, v in ns.items()})
                    apply(i, u[r], rms_u)
        state["step"].copy_(step)
        return params, state, dict(gnorm=gnorm, lr=lr)

    return Optimizer(init, update)


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
