"""Shared model machinery: the reference's initializer rules, norms,
RoPE. Counterpart of ``repro/models/common.py``.

Parameters live in ``nn.Module``s under the reference's names and
layouts (``wq`` is ``(D, Hq, hd)``, and so on), so a reference pytree
maps onto them leaf by leaf (``repro_torch.interop``). Each parameter
carries its init rule (``init``, ``init_scale``), which ``init_tensor``
applies as ``repro.models.common.init_params`` does.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (a config's dtype field) -> torch."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def new_param(shape, init: str = "normal", scale: float = 1.0, *,
              device, dtype) -> nn.Parameter:
    """An uninitialized inference parameter that records its init rule."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                     requires_grad=False)
    p.init, p.init_scale = init, scale
    return p


def init_tensor(shape, init: str, scale: float, generator: torch.Generator,
                dtype) -> torch.Tensor:
    """One leaf drawn under the rules of ``init_params``: zeros, ones,
    ``embed`` (normal x scale), ``small`` (normal x 0.02 x scale), else a
    normal scaled by 1/sqrt(fan-in), fan-in = prod(shape[:-1]). Drawn in
    float32 on the generator's device, then cast to ``dtype``."""
    dev = generator.device
    if init == "zeros":
        return torch.zeros(shape, device=dev, dtype=dtype)
    if init == "ones":
        return torch.ones(shape, device=dev, dtype=dtype)
    z = torch.randn(shape, generator=generator, device=dev,
                    dtype=torch.float32)
    if init == "embed":
        std = scale
    elif init == "small":
        std = 0.02 * scale
    else:
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        std = scale / math.sqrt(max(fan_in, 1))
    return (z * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps):
    """``(1 + w)`` form, computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x, w, b, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


class Norm(nn.Module):
    """RMSNorm (``w`` zeros: the ``(1 + w)`` form) or LayerNorm (``w``
    ones, ``b`` zeros), as ``norm_template``."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        self.layer = cfg.norm_type == "layernorm"
        self.eps = cfg.norm_eps
        D = cfg.d_model
        if self.layer:
            self.w = new_param((D,), "ones", device=device, dtype=dtype)
            self.b = new_param((D,), "zeros", device=device, dtype=dtype)
        else:
            self.w = new_param((D,), "zeros", device=device, dtype=dtype)

    def forward(self, x):
        return apply_norm(self, x)


def apply_norm(p: Norm, x):
    """The reference's ``apply_norm(p, x, cfg)``; the module carries the
    norm type and eps."""
    if p.layer:
        return layernorm(x, p.w, p.b, p.eps)
    return rmsnorm(x, p.w, p.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """Half-split rotation. x: (..., S, H, hd); positions: (..., S) int.
    Angles in float32; an odd last channel passes through."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd % 2:
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(x.dtype)


def padded_vocab(cfg, multiple: int = 128) -> int:
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple
