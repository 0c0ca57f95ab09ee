"""Shared model machinery: the reference's initializer rules, norms,
RoPE. Counterpart of ``repro/models/common.py``.

Structure is declared once, as in the reference, by *template* trees
whose leaves are ``P(shape, axes, init, scale)`` (the reference's
``model_template``, ``cache_template`` and the block templates, copied
leaf for leaf): they give the modules' parameters and the specs of
``distributed.sharding.spec_tree``. Parameters live in ``nn.Module``s
under the reference's names and layouts (``wq`` is ``(D, Hq, hd)``, and
so on), so a reference pytree maps onto them leaf by leaf
(``repro_torch.interop``). Each parameter carries its init rule
(``init``, ``init_scale``), which ``init_tensor`` applies as
``repro.models.common.init_params`` does, its logical ``axes`` and its
``full_shape``: under a ``ShardCtx`` a module holds this rank's shard of
each leaf (``add_params``).

Under FSDP (the rules put ``embed`` on a ``data`` axis of more than one
rank) a module holds each leaf with an ``embed`` dim cut along it over
``data``; ``gathered(module)`` is what a forward reads instead of the
module: each such leaf gathered whole when first read
(``collectives.fsdp_gather``, its gradient reduce-scattered back), every
other attribute the module's own. The gathered leaves live as long as
that forward's autograd graph needs them; under remat the recompute
gathers them again. Without FSDP ``gathered`` returns the module itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.collectives import fsdp_gather


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (a config's dtype field) -> torch."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter template leaf."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names, len == ndim
    init: str = "normal"                 # normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def stack_templates(template, n: int):
    """Add a leading `layers` axis of size n to every leaf (scan stacking)."""
    if isinstance(template, dict):
        return {k: stack_templates(v, n) for k, v in template.items()}
    t = template
    return P((n,) + t.shape, ("layers",) + t.axes, t.init, t.scale)


def add_params(module: nn.Module, template: dict, ctx=None, *, device,
               dtype) -> None:
    """Register a parameter on ``module`` for each leaf of a flat
    template, in its order: the leaf's shape, or under ``ctx`` this
    rank's shard of it (``ShardCtx.local_shape``)."""
    for name, t in template.items():
        shape = t.shape if ctx is None else ctx.local_shape(t.shape, t.axes)
        setattr(module, name, new_param(shape, t.init, t.scale,
                                        device=device, dtype=dtype,
                                        axes=t.axes, full_shape=t.shape))
        if "embed" in t.axes and fsdp_axis(ctx) is not None:
            module.fsdp_ctx = ctx


def fsdp_axis(ctx):
    """The mesh axis FSDP cuts the ``embed`` dims over, None where the
    rules cut none (or it has one rank)."""
    if ctx is None:
        return None
    axis = ctx.rules.get("embed")
    return axis if axis is not None and ctx.size(axis) > 1 else None


class _Gathered:
    """A module's attributes with its FSDP shards gathered whole, each
    once; submodules come wrapped alike."""

    def __init__(self, module):
        object.__setattr__(self, "_m", module)
        object.__setattr__(self, "_got", {})

    def __getattr__(self, name):
        got = self._got
        if name in got:
            return got[name]
        v = getattr(self._m, name)
        if isinstance(v, nn.Parameter) and v.axes and "embed" in v.axes:
            ctx = self._m.fsdp_ctx
            v = fsdp_gather(v, ctx, fsdp_axis(ctx), v.axes.index("embed"))
        elif isinstance(v, nn.Module):
            v = gathered(v)
        got[name] = v
        return v


def gathered(module):
    """What a forward reads of ``module``: the module itself, or under
    FSDP a view with its ``embed``-sharded leaves gathered whole."""
    if getattr(module, "fsdp_ctx", None) is None:
        return module
    return _Gathered(module)


def new_param(shape, init: str = "normal", scale: float = 1.0, *,
              device, dtype, axes=None, full_shape=None) -> nn.Parameter:
    """An uninitialized parameter that records its init rule. It is
    created frozen, for serving; training turns every parameter on
    (``train.trainer.trainable_params``)."""
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                     requires_grad=False)
    p.init, p.init_scale = init, scale
    p.axes = axes
    p.full_shape = tuple(shape) if full_shape is None else tuple(full_shape)
    return p


def init_tensor(shape, init: str, scale: float, generator: torch.Generator,
                dtype) -> torch.Tensor:
    """One leaf drawn under the rules of ``init_params``: zeros, ones,
    ``embed`` (normal x scale), ``small`` (normal x 0.02 x scale), else a
    normal scaled by 1/sqrt(fan-in), fan-in = prod(shape[:-1]). Drawn in
    float32 on the generator's device, scaled in place (so a stacked
    leaf costs one float32 copy at its peak, not two), then cast to
    ``dtype``."""
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
    return z.mul_(std).to(dtype)


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


def norm_template(cfg):
    if cfg.norm_type == "layernorm":
        return {"w": P((cfg.d_model,), ("embed",), "ones"),
                "b": P((cfg.d_model,), ("embed",), "zeros")}
    return {"w": P((cfg.d_model,), ("embed",), "zeros")}  # rms: (1+w) form


class Norm(nn.Module):
    """RMSNorm (``w`` zeros: the ``(1 + w)`` form) or LayerNorm (``w``
    ones, ``b`` zeros), as ``norm_template``."""

    def __init__(self, cfg, *, device, dtype, ctx=None):
        super().__init__()
        self.layer = cfg.norm_type == "layernorm"
        self.eps = cfg.norm_eps
        add_params(self, norm_template(cfg), ctx, device=device, dtype=dtype)

    def forward(self, x):
        return apply_norm(gathered(self), x)


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
