"""Dense MLP variants: SwiGLU / GeGLU / plain GELU with biases.
Counterpart of ``repro/models/mlp.py``. GELU is the tanh form, as
``jax.nn.gelu``'s default.

Under a ``ShardCtx`` whose rules put ``ff`` on the ``model`` axis the
module holds its columns of ``wg``/``wu``/``wi`` and rows of ``wd``: the
input, replicated over ``model``, enters the rank's columns through
``copy_to`` (its gradient summed over ``model``), and the down
projection gives a partial sum, added over ``model`` (``all_sum``)
before the bias. Under FSDP the forward reads its leaves gathered
(``common.gathered``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import all_sum, copy_to
from repro_torch.models.common import P, add_params, gathered


def mlp_template(cfg, d_ff: int = 0, ff_axis: str = "ff"):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "wg": P((D, Fd), ("embed", ff_axis)),
            "wu": P((D, Fd), ("embed", ff_axis)),
            "wd": P((Fd, D), (ff_axis, "embed")),
        }
    # plain gelu (starcoder2, musicgen)
    return {
        "wi": P((D, Fd), ("embed", ff_axis)),
        "bi": P((Fd,), (ff_axis,), "zeros"),
        "wd": P((Fd, D), (ff_axis, "embed")),
        "bd": P((D,), ("embed",), "zeros"),
    }


class MLP(nn.Module):
    def __init__(self, cfg, d_ff: int = 0, *, device, dtype, ctx=None):
        super().__init__()
        self.mlp_type = cfg.mlp_type
        # the context of the row-parallel sum, None when ff is whole
        self.ctx = ctx if ctx is not None and ctx.sharded("ff") else None
        add_params(self, mlp_template(cfg, d_ff), ctx, device=device,
                   dtype=dtype)

    @property
    def gated(self) -> bool:
        return self.mlp_type in ("swiglu", "geglu")

    def forward(self, x):
        return mlp_apply(gathered(self), x)


def mlp_apply(p: MLP, x, reduce: bool = True):
    """The MLP of ``x``. With ``reduce=False`` under a sharded ``ff``, the
    rank's partial sum without the bias ``bd`` (the caller sums over
    ``model`` and adds it)."""
    x = copy_to(x, p.ctx)
    if p.gated:
        g = x @ p.wg
        u = x @ p.wu
        act = (F.silu(g) if p.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        y = (act * u) @ p.wd
        return all_sum(y, p.ctx) if reduce else y
    h = x @ p.wi + p.bi.to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    y = h @ p.wd
    if not reduce:
        return y
    return all_sum(y, p.ctx) + p.bd.to(x.dtype)
