"""Dense MLP variants: SwiGLU / GeGLU / plain GELU with biases.
Counterpart of ``repro/models/mlp.py``. GELU is the tanh form, as
``jax.nn.gelu``'s default."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import new_param


class MLP(nn.Module):
    def __init__(self, cfg, d_ff: int = 0, *, device, dtype):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        self.mlp_type = cfg.mlp_type
        kw = dict(device=device, dtype=dtype)
        if self.gated:
            self.wg = new_param((D, Fd), **kw)
            self.wu = new_param((D, Fd), **kw)
            self.wd = new_param((Fd, D), **kw)
        else:  # plain gelu (starcoder2, musicgen)
            self.wi = new_param((D, Fd), **kw)
            self.bi = new_param((Fd,), "zeros", **kw)
            self.wd = new_param((Fd, D), **kw)
            self.bd = new_param((D,), "zeros", **kw)

    @property
    def gated(self) -> bool:
        return self.mlp_type in ("swiglu", "geglu")

    def forward(self, x):
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x):
    if p.gated:
        g = x @ p.wg
        u = x @ p.wu
        act = (F.silu(g) if p.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        return (act * u) @ p.wd
    h = x @ p.wi + p.bi.to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ p.wd + p.bd.to(x.dtype)

