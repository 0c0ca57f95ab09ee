"""Dense MLP variants: SwiGLU / GeGLU / plain GELU with biases.
Counterpart of ``repro/models/mlp.py``. GELU is the tanh form, as
``jax.nn.gelu``'s default.

Under a ``ShardCtx`` whose rules put ``ff`` on the ``model`` axis the
module holds its columns of ``wg``/``wu``/``wi`` and rows of ``wd``: the
input, replicated over ``model``, enters the rank's columns through
``copy_to`` (its gradient summed over ``model``), and the down
projection gives a partial sum, added over ``model`` (``all_sum``)
before the bias. Under sequence parallelism (``seq`` on ``model``) the
input is the rank's slice of the sequence: it is gathered whole at the
entry (``gather_seq``) and the down projection's partial sums are
reduce-scattered back to the slice (``scatter_seq``); with ``ff`` whole
the MLP runs on the slice alone, token by token. Under FSDP the forward
reads its leaves gathered (``common.gathered``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.collectives import (all_sum, copy_to,
                                                 gather_seq, scatter_seq)
from repro_torch.models.common import (P, add_params, gathered,
                                       mark_seq_partial, seq_ctx)


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
        # sequence parallelism with ff split: the gather and the
        # reduce-scatter around the rank's columns
        self.seq = seq_ctx(ctx) if self.ctx is not None else None
        add_params(self, mlp_template(cfg, d_ff), ctx, device=device,
                   dtype=dtype)
        if seq_ctx(ctx) is not None and self.ctx is None:
            mark_seq_partial(*self.parameters())    # on the slice
        elif self.seq is not None and not self.gated:
            mark_seq_partial(self.bd)       # after the reduce-scatter

    @property
    def gated(self) -> bool:
        return self.mlp_type in ("swiglu", "geglu")

    def forward(self, x):
        return mlp_apply(gathered(self), x)


def mlp_apply(p: MLP, x, reduce: bool = True):
    """The MLP of ``x``. With ``reduce=False`` under a sharded ``ff``, the
    rank's partial sum without the bias ``bd`` (the caller sums over
    ``model`` and adds it); under sequence parallelism ``x`` is then the
    whole sequence, gathered by the caller."""
    if p.seq is None:
        x = copy_to(x, p.ctx)
    elif reduce:
        x = gather_seq(x, p.seq)
    if p.gated:
        g = x @ p.wg
        u = x @ p.wu
        act = (F.silu(g) if p.mlp_type == "swiglu"
               else F.gelu(g, approximate="tanh"))
        y = (act * u) @ p.wd
    else:
        h = x @ p.wi + p.bi.to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        y = h @ p.wd
    if not reduce:
        return y
    y = all_sum(y, p.ctx) if p.seq is None else scatter_seq(y, p.seq)
    return y if p.gated else y + p.bd.to(x.dtype)
