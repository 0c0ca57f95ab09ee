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
would double that. ``state_template`` and ``opt_spec_tree`` build
``PartitionSpec`` trees and wait for the mesh tooling.
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


def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    # a tensor over a tensor: ``max_norm / t`` is ``t.reciprocal() *
    # max_norm`` in torch, which rounds twice
    scale = torch.clamp(torch.full_like(gn, max_norm)
                        / torch.clamp(gn, min=1e-9), max=1.0)
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
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        t = step.to(F32)
        lr = lr_fn(step)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for p, m_, v_, g in zip(tree_leaves(params), tree_leaves(state["m"]),
                                tree_leaves(state["v"]), tree_leaves(grads)):
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


def adafactor(lr_fn, eps: float = 1e-30, clip_thresh: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        def per_leaf(p):
            z = dict(dtype=F32, device=p.device)
            if _factored(p.shape):
                return dict(vr=torch.zeros(p.shape[:-1], **z),
                            vc=torch.zeros(p.shape[:-2] + p.shape[-1:], **z))
            return dict(v=torch.zeros(p.shape, **z))
        dev = tree_leaves(params)[0].device
        return dict(v=tree_map(per_leaf, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        t = step.to(F32)
        beta = 1.0 - torch.pow(t, -decay)
        lr = lr_fn(step)

        def per_leaf(g, s, p):
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                       min=eps))
                u = g * torch.rsqrt(denom + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            # update clipping by RMS (Adafactor's d = 1.0 rule)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms_u / clip_thresh, min=1.0)
            pf = p.float()
            p.copy_((pf - lr * (u + weight_decay * pf)).to(p.dtype))

        for g, p, k in zip(tree_leaves(grads), tree_leaves(params),
                           _leaf_paths(params)):
            per_leaf(g, _get(state["v"], k), p)
        state["step"].copy_(step)
        return params, state, dict(gnorm=gnorm, lr=lr)

    return Optimizer(init, update)


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
