"""Public wrapper of the ``matern_score`` kernel. Counterpart of
``repro/kernels/matern_score/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel masks the ragged candidate edge itself.
``matern_score.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matern_score import kernel
from repro_torch.kernels.matern_score.ref import matern_score_ref


def _check(cand, x, alpha, mask, ls, sv):
    named = dict(cand=cand, x=x, alpha=alpha, mask=mask, ls=ls, sv=sv)
    for name, t in named.items():
        if t.device != cand.device:
            raise ValueError(f"matern_score: {name} is on {t.device}, "
                             f"cand on {cand.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"matern_score: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"matern_score: {name} must be contiguous")
    if cand.ndim != 3 or x.ndim != 3:
        raise ValueError("matern_score: cand and x must be (S, N, d) and "
                         f"(S, n, d), got {tuple(cand.shape)} and "
                         f"{tuple(x.shape)}")
    S, _, d = cand.shape
    n = x.shape[1]
    want = dict(x=(S, n, d), alpha=(S, n), mask=(S, n), ls=(S,), sv=(S,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"matern_score: {name} has shape "
                             f"{tuple(named[name].shape)}, expected {shape}")
    if S > 65535:
        raise ValueError(f"matern_score: S={S} exceeds the grid's 65535 "
                         "scenario rows")


def matern_score(cand, x, alpha, mask, ls, sv):
    """Batched masked Matérn-5/2 posterior-mean scores (standardized).

    cand (S,N,d), x (S,n,d), alpha (S,n), mask (S,n), ls (S,), sv (S,)
    -> (S,N) float32.
    """
    if cand.device.type == "cpu":
        return matern_score_ref(cand, x, alpha, mask, ls, sv)
    if cand.device.type != "cuda":
        raise ValueError(f"matern_score runs on CUDA or the CPU, not "
                         f"{cand.device}")
    _check(cand, x, alpha, mask, ls, sv)
    out = torch.empty(cand.shape[:2], dtype=torch.float32,
                      device=cand.device)
    kernel.launch(cand, x, alpha, mask, ls, sv, out)
    matern_score.launches += 1
    return out


matern_score.launches = 0
