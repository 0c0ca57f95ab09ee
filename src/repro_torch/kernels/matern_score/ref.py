"""Plain PyTorch version of the batched Matérn-5/2 scoring kernel: the
standardized GP posterior mean of every candidate in every scenario,
``(S, N)``, from the scenarios' fitted ``alpha`` vectors. Counterpart of
``repro/kernels/matern_score/ref.py::matern_score_ref``.

It is what ``ops.matern_score`` returns for tensors on the CPU, and what
the CUDA kernel is held against on the card. Elementwise torch, no
``cdist``.
"""
from __future__ import annotations

import torch

SQRT5 = 2.23606797749979


def matern_score_ref(cand, x, alpha, mask, ls, sv):
    """cand (S,N,d), x (S,n,d), alpha (S,n), mask (S,n), ls (S,), sv (S,)
    -> scores (S,N): masked cross-kernel mat-vec k(cand, x) @ alpha."""
    d2 = torch.sum(torch.square(cand[:, :, None, :] - x[:, None, :, :]),
                   dim=-1)                                     # (S, N, n)
    r = torch.sqrt(d2.clamp(min=1e-16)) / ls[:, None, None]
    k = (sv[:, None, None] * (1.0 + SQRT5 * r + 5.0 * r * r / 3.0)
         * torch.exp(-SQRT5 * r))
    k = k * mask.to(k.dtype)[:, None, :]
    return (k @ alpha[:, :, None])[..., 0]
