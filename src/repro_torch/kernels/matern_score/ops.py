"""Public wrappers of the ``matern_score`` kernels. Counterpart of
``repro/kernels/matern_score/ops.py``.

``matern_score`` is the TPU kernel's function, the standardized mean of
a candidate block. ``matern_posterior`` gives the block's whole
posterior (mean, sigma and mean gradient on the raw scale, for d = 2
and at most ``MAX_POINTS`` training points) from one launch of the same
source. For tensors on the CPU each returns its plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
they pad nothing; the kernels mask the ragged candidate edge
themselves. ``matern_score.launches`` counts the launches of both
entries; ``matern_posterior.launches`` those of the posterior alone.
``posterior_plan`` decides, from shapes alone, what ``matern_score.cu``
launches for the posterior.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.matern_score import kernel
from repro_torch.kernels.matern_score.ref import (matern_posterior_ref,
                                                  matern_score_ref)

MAX_POINTS = 64             # GPConfig.max_points: the largest instance
INSTANCES = (16, 32, 48, 64)
THREADS = 128               # a posterior block at most
SMS = 132                   # an H100 SXM's SMs


def _check(what, named, want, any_layout=()):
    """One device, float32, contiguous (but the names in ``any_layout``),
    and the shapes of ``want``."""
    ref = next(iter(named.values()))
    for name, t in named.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, cand on "
                             f"{ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")
        if name not in any_layout and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(named[name].shape)}, expected {shape}")
    if ref.shape[0] > 65535:
        raise ValueError(f"{what}: S={ref.shape[0]} exceeds the grid's "
                         "65535 scenario rows")


def _check_score(cand, x, alpha, mask, ls, sv):
    if cand.ndim != 3 or x.ndim != 3:
        raise ValueError("matern_score: cand and x must be (S, N, d) and "
                         f"(S, n, d), got {tuple(cand.shape)} and "
                         f"{tuple(x.shape)}")
    S, _, d = cand.shape
    n = x.shape[1]
    _check("matern_score",
           dict(cand=cand, x=x, alpha=alpha, mask=mask, ls=ls, sv=sv),
           dict(x=(S, n, d), alpha=(S, n), mask=(S, n), ls=(S,), sv=(S,)))


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
    _check_score(cand, x, alpha, mask, ls, sv)
    out = torch.empty(cand.shape[:2], dtype=torch.float32,
                      device=cand.device)
    kernel.launch(cand, x, alpha, mask, ls, sv, out)
    matern_score.launches += 1
    return out


matern_score.launches = 0


def _check_posterior(cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma):
    if cand.ndim != 3 or cand.shape[-1] != 2:
        raise ValueError("matern_posterior: cand must be (S, N, 2), got "
                         f"{tuple(cand.shape)}")
    if x.ndim != 3:
        raise ValueError(f"matern_posterior: x must be (S, n, 2), got "
                         f"{tuple(x.shape)}")
    S = cand.shape[0]
    n = x.shape[1]
    if n > MAX_POINTS:
        raise ValueError(f"matern_posterior: n={n} points, at most "
                         f"{MAX_POINTS}")
    _check("matern_posterior",
           dict(cand=cand, x=x, alpha=alpha, mask=mask, L=L, ls=ls, sv=sv,
                y_mu=y_mu, y_sigma=y_sigma),
           dict(x=(S, n, 2), alpha=(S, n), mask=(S, n), L=(S, n, n),
                ls=(S,), sv=(S,), y_mu=(S,), y_sigma=(S,)),
           any_layout=("L",))
    if cand.data_ptr() % 8:
        raise ValueError("matern_posterior: cand must be 8-byte aligned "
                         "(the kernel reads a candidate as one float2)")


def matern_posterior(cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma):
    """Posterior of a candidate block under S fitted GPs, raw scale.

    cand (S,N,2), x (S,n,2), alpha (S,n), mask (S,n), L (S,n,n) lower
    Cholesky factor, ls, sv, y_mu, y_sigma (S,), n <= 64
    -> mu (S,N), sigma (S,N), dmu (S,N,2), float32.

    L may have any layout: the kernel reads its columns, so it takes
    ``L.mT`` contiguous, which costs no copy for the column-major factor
    ``torch.linalg.cholesky_ex`` returns. The kernel's gradient takes
    the reference's factor r / max(r, 1e-12) as 1, which it is for
    every candidate while ls <= 5000 (the GP's fit keeps ls in
    [0.02, 3]).
    """
    _check_posterior(cand, x, alpha, mask, L, ls, sv, y_mu, y_sigma)
    if cand.device.type == "cpu":
        return matern_posterior_ref(cand, x, alpha, mask, L, ls, sv, y_mu,
                                    y_sigma)
    if cand.device.type != "cuda":
        raise ValueError(f"matern_posterior runs on CUDA or the CPU, not "
                         f"{cand.device}")
    S, N, _ = cand.shape
    plan = posterior_plan(S, N, x.shape[1])
    mu = torch.empty((S, N), dtype=torch.float32, device=cand.device)
    sigma = torch.empty_like(mu)
    dmu = torch.empty((S, N, 2), dtype=torch.float32, device=cand.device)
    kernel.launch_posterior(cand, x, alpha, mask, L.mT.contiguous(), ls, sv,
                            y_mu, y_sigma, mu, sigma, dmu, plan.instance,
                            plan.threads)
    matern_posterior.launches += 1
    matern_score.launches += 1
    return mu, sigma, dmu


matern_posterior.launches = 0


@dataclasses.dataclass(frozen=True)
class PosteriorPlan:
    """One posterior launch. Block (x, s) holds scenario s's L (its
    columns), points and their terms in shared memory; its thread t owns
    candidate x * threads + t."""
    S: int
    N: int
    n: int
    instance: int               # NMAX: n is padded to it in shared memory
    threads: int
    grid: tuple                 # (candidate tiles, S)
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def one_wave_blocks_per_sm(self) -> int:
        """Blocks each SM must hold for the grid to run in one wave."""
        return -(-self.blocks // SMS)

    def waves(self, blocks_per_sm: int) -> int:
        """Waves of the grid where an SM holds ``blocks_per_sm`` blocks
        (the built kernel's occupancy)."""
        return -(-self.blocks // (blocks_per_sm * SMS))

    def candidates(self, x: int) -> range:
        return range(x * self.threads, min((x + 1) * self.threads, self.N))


def instance(n: int) -> int:
    """The smallest posterior instance that holds n points."""
    for nmax in INSTANCES:
        if n <= nmax:
            return nmax
    raise ValueError(f"matern_posterior: n={n} points, at most "
                     f"{MAX_POINTS}")


def posterior_threads(S: int, N: int) -> int:
    """THREADS a block, halved (to 32 at least) while the grid would
    leave SMs without a block: S = 1 at N 4,178 takes 131 blocks of 32."""
    t = THREADS
    while t > 32 and S * -(-N // t) < SMS:
        t //= 2
    return t


def posterior_smem_bytes(nmax: int) -> int:
    """Shared memory of a block: the columns of L (nmax^2), each point's
    x, w and gradient factor (4 nmax), its mask and 1/L_jj (2 nmax), all
    float32."""
    return 4 * (nmax * nmax + 6 * nmax)


def posterior_plan(S: int, N: int, n: int) -> PosteriorPlan:
    """What ``matern_posterior`` launches for the posterior of S x N
    candidates under GPs of n points."""
    nmax = instance(n)
    threads = posterior_threads(S, N)
    return PosteriorPlan(S=S, N=N, n=n, instance=nmax, threads=threads,
                         grid=(-(-N // threads), S),
                         smem_bytes=posterior_smem_bytes(nmax))
