"""Plain PyTorch versions of the two ``matern_score`` entries.

``matern_score_ref``: the standardized GP posterior mean of every
candidate in every scenario, ``(S, N)``, from the scenarios' fitted
``alpha`` vectors; counterpart of
``repro/kernels/matern_score/ref.py::matern_score_ref``.
``matern_posterior_ref``: mean, sigma and mean gradient of a candidate
block on the raw scale, as the reference's
``gp.posterior_with_grad_batch`` computes them.

They are what ``ops.matern_score`` and ``ops.matern_posterior`` return
for tensors on the CPU, and what the CUDA kernels are held against on
the card. Elementwise torch, no ``cdist``.
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


def matern_posterior_ref(cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma):
    """The posterior of a candidate block, on the raw scale: the jnp
    expression of ``repro/core/gp.py::posterior_with_grad_batch``, with a
    leading scenario axis.

    cand (S,N,2), x (S,n,2), alpha (S,n), mask (S,n), L (S,n,n) lower,
    ls, sv, y_mu, y_sigma (S,) -> mu (S,N), sigma (S,N), dmu (S,N,2).
    """
    ls3, sv3 = ls[:, None, None], sv[:, None, None]
    diff = x[:, :, None, :] - cand[:, None, :, :]              # (S, n, N, 2)
    d2 = torch.sum(torch.square(diff), dim=-1)                  # (S, n, N)
    r = torch.sqrt(d2.clamp(min=1e-16)) / ls3
    e = torch.exp(-SQRT5 * r)
    k = sv3 * (1.0 + SQRT5 * r + 5.0 * r * r / 3.0) * e
    ks = k * mask[:, :, None]
    # ks^T alpha, with ks^T laid out as matern_score_ref's k: the two
    # plain means agree bit for bit
    mu_std = (ks.transpose(-1, -2).contiguous() @ alpha[..., None])[..., 0]
    v = torch.linalg.solve_triangular(L, ks, upper=False)
    var = (sv[:, None] - torch.sum(torch.square(v), dim=-2)).clamp(min=1e-12)
    # d mu_std / d a = sum_i alpha_i mask_i dk/dr * (a - x_i) / (ls^2 r)
    dkdr = -(5.0 / 3.0) * sv3 * r * (1.0 + SQRT5 * r) * e
    coef = (alpha * mask)[:, :, None] * dkdr / (r.clamp(min=1e-12) * ls3
                                                 * ls3)
    dmu_std = torch.einsum("snN,snNd->sNd", coef, -diff)
    ys = y_sigma[:, None]
    return (mu_std * ys + y_mu[:, None], torch.sqrt(var) * ys,
            dmu_std * ys[..., None])
