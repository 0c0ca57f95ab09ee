"""Gaussian-process surrogate (§5.1): zero-mean, Matérn-5/2, no ARD.
Counterpart of ``repro/core/gp.py``.

Fixed-size padded buffers (the masked-kernel construction) and dataset
buckets keep the shapes few. Hyperparameters (log lengthscale, log
signal, log noise) are optimized by Adam on the exact marginal
likelihood. Targets are standardized internally.

Batching: the reference writes one lane and ``vmap``s it. Here every
function takes leaves with any leading lane shape ``B`` (empty for one
GP, ``(S,)`` for a batch) written out: datasets are ``x (*B, m, d)``,
``y (*B, m)``, ``mask (*B, m)``; thetas and per-lane scalars are
``(*B,)``. Lanes never mix, so ``torch.autograd.grad`` of the per-lane
sum gives every lane its own gradient.

Values are float32 as in the reference (x64 off). Use
``torch.linalg.cholesky_ex``: the factor of a lane whose kernel is not
positive definite is set to NaN, as JAX's Cholesky returns NaN there and
:func:`theta_finite` relies on it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SQRT5 = 2.23606797749979
F32 = torch.float32
LOG_2PI = math.log(2 * math.pi)


def _f32(v, like):
    """A Python/numpy constant as a float32 tensor on ``like``'s device
    (the reference evaluates such constants in float32)."""
    return torch.as_tensor(v, dtype=F32, device=like.device)


def matern52(x1, x2, lengthscale, signal_var):
    """x1: (*B, N, d), x2: (*B, M, d); lengthscale/signal_var (*B,)
    -> (*B, N, M)."""
    ls = torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device)
    sv = torch.as_tensor(signal_var, dtype=x1.dtype, device=x1.device)
    d2 = torch.sum(torch.square(x1[..., :, None, :] - x2[..., None, :, :]),
                   dim=-1)
    r = torch.sqrt(d2.clamp(min=1e-16)) / ls[..., None, None]
    return (sv[..., None, None] * (1.0 + SQRT5 * r + 5.0 * r * r / 3.0)
            * torch.exp(-SQRT5 * r))


@dataclasses.dataclass(frozen=True)
class GPConfig:
    max_points: int = 64
    fit_steps: int = 150
    fit_lr: float = 0.05
    init_lengthscale: float = 0.3
    init_noise: float = 1e-3
    jitter: float = 1e-6
    # warm-started refits: Adam from the previous iteration's
    # hyperparameters, stopping early once the MLL gradient norm drops
    # below warm_gtol (docs/engine.md §warm-start)
    warm_steps: int = 30
    warm_gtol: float = 0.1


DATASET_BUCKETS = (16, 32, 48, 64)
THETA_KEYS = ("log_ls", "log_sv", "log_nv")


def bucket_size(n_pts: int, max_points: int) -> int:
    """Smallest dataset bucket covering n_pts active points.

    The masked-kernel construction makes the padded block an exact
    identity block, so fitting on the first ``m`` rows is mathematically
    identical to the full ``max_points`` layout while the Cholesky cost
    drops as m^3."""
    for b in DATASET_BUCKETS:
        if b >= min(n_pts, max_points):
            return min(b, max_points)
    return max_points


def slice_data(data, m: int):
    """First-m-rows view of a (batched or single) padded dataset."""
    return dict(x=data["x"][..., :m, :], y=data["y"][..., :m],
                mask=data["mask"][..., :m])


def as_dataset(data, device) -> dict:
    """A host dataset (numpy, any float width) as device tensors with the
    reference's dtypes: float32 ``x``/``y``, bool ``mask``."""
    return dict(x=torch.as_tensor(np.asarray(data["x"])).to(device, F32),
                y=torch.as_tensor(np.asarray(data["y"])).to(device, F32),
                mask=torch.as_tensor(np.asarray(data["mask"])).to(
                    device, torch.bool))


def _standardize(y, mask, prior=None):
    """Target standardization with an optional transfer-learned mean prior.

    ``prior`` is a dict with per-lane ``mu0``/``n0``: ``n0`` pseudo-
    observations at ``mu0`` shrink the centering mean toward the prior.
    ``prior=None`` — and, by the same arithmetic, ``n0 == 0`` — keeps the
    data-only standardization."""
    cnt = mask.sum(-1)
    n = cnt.clamp(min=1)
    ym = torch.where(mask, y, torch.zeros_like(y)).sum(-1)
    if prior is None:
        mu = ym / n
    else:
        ns = cnt + prior["n0"]
        mu = (ym + prior["n0"] * prior["mu0"]) / ns.clamp(min=1.0)
    dev = torch.where(mask, torch.square(y - mu[..., None]),
                      torch.zeros_like(y))
    var = dev.sum(-1) / n
    std = torch.sqrt(var.clamp(min=1e-8))
    return (y - mu[..., None]) * mask / std[..., None], mu, std


def _masked_kernel(x, mask, theta, jitter):
    ls, sv, nv = (torch.exp(theta["log_ls"]), torch.exp(theta["log_sv"]),
                  torch.exp(theta["log_nv"]))
    K = matern52(x, x, ls, sv)
    m2 = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    # padded rows/cols -> identity block (contributes 0 to MLL, exact for
    # the active block)
    diag = torch.where(mask, (nv + jitter)[..., None], torch.ones_like(
        mask, dtype=x.dtype))
    return torch.where(m2, K, torch.zeros_like(K)) + eye * diag[..., None, :]


def cholesky(K):
    """Lower Cholesky factor; lanes whose matrix is not positive definite
    get NaN on and below the diagonal (JAX's behaviour), not an exception
    and not ``cholesky_ex``'s partial factor."""
    L, info = torch.linalg.cholesky_ex(K)
    tril = torch.ones(L.shape[-2:], dtype=torch.bool, device=L.device).tril()
    bad = (info != 0)[..., None, None] & tril
    # added, not selected, so the NaN downstream reaches a failed lane's
    # gradient, as in JAX (a select would send that lane zeros)
    return L + torch.where(bad, float("nan"), 0.0).to(L.dtype)


def _cho_solve(L, b):
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _neg_mll(theta, x, y_std, mask, jitter):
    """Per-lane negative log marginal likelihood, shape (*B,)."""
    K = _masked_kernel(x, mask, theta, jitter)
    L = cholesky(K)
    alpha = _cho_solve(L, y_std)
    n = mask.sum(-1).clamp(min=1)
    quad = 0.5 * torch.sum(y_std * alpha, dim=-1)
    logd = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    logdet = torch.sum(torch.where(mask, logd, torch.zeros_like(logd)),
                       dim=-1)
    return quad + logdet + 0.5 * n * LOG_2PI


def _mll_grad(theta, x, y_std, mask, jitter):
    """Per-lane gradient of :func:`_neg_mll` w.r.t. theta (a dict)."""
    with torch.enable_grad():
        leaves = {k: theta[k].detach().requires_grad_(True)
                  for k in THETA_KEYS}
        nll = _neg_mll(leaves, x, y_std, mask, jitter)
        gs = torch.autograd.grad(nll.sum(), [leaves[k] for k in THETA_KEYS])
    return dict(zip(THETA_KEYS, gs))


def init_theta(cfg: GPConfig, shape=(), device="cuda"):
    """Cold-start hyperparameters (log lengthscale / signal / noise),
    broadcast to the lane shape ``shape``."""
    one = torch.ones(shape, dtype=F32, device=device)
    return dict(log_ls=torch.log(_f32(cfg.init_lengthscale, one)) * one,
                log_sv=torch.zeros(shape, dtype=F32, device=device),
                log_nv=torch.log(_f32(cfg.init_noise, one)) * one)


def _adam_update(theta, opt, g, lr, t):
    """One Adam step + hyperparameter range clips (t is 1-based, a
    float32 tensor as in the reference)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = {k: b1 * opt["m"][k] + (1 - b1) * g[k] for k in THETA_KEYS}
    v = {k: b2 * opt["v"][k] + (1 - b2) * g[k] * g[k] for k in THETA_KEYS}
    c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    theta = {k: theta[k] - lr * (m[k] / c1)
             / (torch.sqrt(v[k] / c2) + eps) for k in THETA_KEYS}
    # keep hyperparams in sane ranges
    ref = theta["log_ls"]
    theta["log_ls"] = torch.clamp(theta["log_ls"],
                                  torch.log(_f32(0.02, ref)),
                                  torch.log(_f32(3.0, ref)))
    theta["log_nv"] = torch.clamp(theta["log_nv"],
                                  torch.log(_f32(1e-6, ref)),
                                  torch.log(_f32(0.5, ref)))
    return theta, dict(m=m, v=v)


def _zeros_opt(theta):
    return dict(m={k: torch.zeros_like(theta[k]) for k in THETA_KEYS},
                v={k: torch.zeros_like(theta[k]) for k in THETA_KEYS})


def _posterior_cache(theta, data, cfg: GPConfig, y_mu, y_sigma, prior=None):
    K = _masked_kernel(data["x"], data["mask"], theta, cfg.jitter)
    L = cholesky(K)
    alpha = _cho_solve(L, _standardize(data["y"], data["mask"], prior)[0])
    return dict(theta=theta, L=L, alpha=alpha.contiguous(), y_mu=y_mu,
                y_sigma=y_sigma, x=data["x"], mask=data["mask"])


@torch.no_grad()
def _fit_core(data, cfg: GPConfig, prior=None):
    """Returns the fitted posterior cache: ``cfg.fit_steps`` cold Adam
    steps on the MLL, every lane at once."""
    y_std, y_mu, y_sigma = _standardize(data["y"], data["mask"], prior)
    theta = init_theta(cfg, y_mu.shape, y_mu.device)
    opt = _zeros_opt(theta)
    for i in range(cfg.fit_steps):
        g = _mll_grad(theta, data["x"], y_std, data["mask"], cfg.jitter)
        theta, opt = _adam_update(theta, opt, g, cfg.fit_lr,
                                  _f32(i + 1.0, y_mu))
    return _posterior_cache(theta, data, cfg, y_mu, y_sigma, prior)


@torch.no_grad()
def _fit_core_from(data, cfg: GPConfig, theta0, max_steps: int, gtol: float,
                   prior=None):
    """Warm refit: Adam from ``theta0``, stopping per lane once the MLL
    gradient norm drops below ``gtol`` (or after ``max_steps``).

    Returns ``(posterior-cache, steps_used (*B,) int32)``. The reference's
    ``while_loop`` under ``vmap`` steps every lane until all have stopped
    and keeps a finished lane's carry; this masked loop of at most
    ``max_steps + 1`` passes does the same, so ``steps_used`` is exact
    per lane."""
    y_std, y_mu, y_sigma = _standardize(data["y"], data["mask"], prior)
    theta = {k: theta0[k].to(F32) for k in THETA_KEYS}
    opt = _zeros_opt(theta)
    steps = torch.zeros(y_mu.shape, dtype=torch.int32, device=y_mu.device)
    done = torch.zeros(y_mu.shape, dtype=torch.bool, device=y_mu.device)
    for _ in range(max_steps + 1):
        run = (steps < max_steps) & ~done
        if not bool(run.any()):
            break
        g = _mll_grad(theta, data["x"], y_std, data["mask"], cfg.jitter)
        gn = torch.sqrt(sum(torch.square(g[k]) for k in THETA_KEYS))
        conv = gn < gtol
        theta2, opt2 = _adam_update(theta, opt, g, cfg.fit_lr,
                                    steps.to(F32) + 1.0)
        move = run & ~conv

        def sel(a, b):
            return torch.where(move, b, a)

        theta = {k: sel(theta[k], theta2[k]) for k in THETA_KEYS}
        opt = {s: {k: sel(opt[s][k], opt2[s][k]) for k in THETA_KEYS}
               for s in ("m", "v")}
        steps = steps + move.to(torch.int32)
        done = done | (run & conv)
    return _posterior_cache(theta, data, cfg, y_mu, y_sigma, prior), steps


def theta_finite(theta):
    """Per-lane health predicate of a (batched) hyperparameter dict: True
    where every leaf is finite. A diverged fit (NaN gradients from a
    poisoned dataset, an overflowed Adam step, a Cholesky of an
    indefinite kernel) surfaces as a non-finite theta or posterior."""
    ok = torch.isfinite(theta[THETA_KEYS[0]])
    for k in THETA_KEYS[1:]:
        ok = ok & torch.isfinite(theta[k])
    return ok


def scrub_dataset(data):
    """Drop non-finite observations from a (batched) padded dataset:
    poisoned rows are masked out (y zeroed so masked reduces stay
    NaN-free) while append positions are untouched."""
    bad = ~(torch.isfinite(data["y"])
            & torch.all(torch.isfinite(data["x"]), dim=-1))
    return dict(data,
                x=torch.where(bad[..., None], torch.zeros_like(data["x"]),
                              data["x"]),
                y=torch.where(bad, torch.zeros_like(data["y"]), data["y"]),
                mask=data["mask"] & ~bad)


def fit(data, cfg: GPConfig, prior=None):
    """Fit one GP (or a lane batch: the same code serves both)."""
    return _fit_core(data, cfg, prior)


def fit_batch(data, cfg: GPConfig, prior=None):
    """Fit S independent GPs at once. ``data`` is the batched-dataset
    layout ``x (S, m, d)``, ``y (S, m)``, ``mask (S, m)``; returns the
    posterior cache with a leading S axis on every leaf. ``prior``
    optionally carries per-scenario ``mu0 (S,)``, ``n0 (S,)``."""
    return _fit_core(data, cfg, prior)


def take_lanes(tree, idx):
    """Gather rows of a lane-batched dict along the leading scenario
    axis: every leaf ``v -> v[idx]`` (nested dicts included)."""
    if isinstance(tree, dict):
        return {k: take_lanes(v, idx) for k, v in tree.items()}
    return tree[idx]


def pad_lanes_index(rows: int, s_next: int):
    """The gather index that widens an ``rows``-lane dict to ``s_next``
    lanes: the original rows followed by duplicates of row 0."""
    if s_next < rows:
        raise ValueError(f"pad_lanes_index cannot narrow ({rows} -> "
                         f"{s_next})")
    return np.concatenate([np.arange(rows, dtype=np.int64),
                           np.zeros(s_next - rows, np.int64)])


def posterior_batch(gp, A):
    """Fused posterior: A (*B, N, d) -> (mu (*B, N), sigma (*B, N)), raw
    scale. One cross-kernel build + one triangular solve over the
    ``(n, N)`` right-hand side (``ks^T K^-1 ks == |L^-1 ks|^2``)."""
    ls = torch.exp(gp["theta"]["log_ls"])
    sv = torch.exp(gp["theta"]["log_sv"])
    ks = matern52(gp["x"], A, ls, sv) * gp["mask"][..., :, None]
    mu_std = (ks.transpose(-1, -2) @ gp["alpha"][..., None])[..., 0]
    v = torch.linalg.solve_triangular(gp["L"], ks, upper=False)
    var = (sv[..., None] - torch.sum(torch.square(v), dim=-2)).clamp(
        min=1e-12)
    return (mu_std * gp["y_sigma"][..., None] + gp["y_mu"][..., None],
            torch.sqrt(var) * gp["y_sigma"][..., None])


def posterior(gp, a):
    """Posterior mean/std at one point a: (d,) -> (mu, sigma), raw scale."""
    mu, sigma = posterior_batch(gp, a[None])
    return mu[0], sigma[0]


def posterior_with_grad_batch(gp, A):
    """Fused posterior mean/std + analytic mean-gradient:
    A (*B, N, d) -> (mu, sigma (*B, N), dmu (*B, N, d)), raw scale.

    ``dk/dr = -(5/3) sv r (1 + sqrt5 r) e^{-sqrt5 r}`` and
    ``dr/da = (a - x_i) / (ls^2 r)`` reuse the mean's exp/sqrt values.
    The expression is differentiable in ``A``, which the acquisition
    refinement needs; a candidate block takes its posterior from the
    ``matern_posterior`` kernel instead (``acquisition.block_posterior``).
    """
    ls = torch.exp(gp["theta"]["log_ls"])[..., None, None]
    sv = torch.exp(gp["theta"]["log_sv"])[..., None, None]
    diff = gp["x"][..., :, None, :] - A[..., None, :, :]      # (*B, n, N, d)
    d2 = torch.sum(torch.square(diff), dim=-1)                # (*B, n, N)
    r = torch.sqrt(d2.clamp(min=1e-16)) / ls
    e = torch.exp(-SQRT5 * r)
    k = sv * (1.0 + SQRT5 * r + 5.0 * r * r / 3.0) * e
    ks = k * gp["mask"][..., :, None]                          # (*B, n, N)
    mu_std = (ks.transpose(-1, -2) @ gp["alpha"][..., None])[..., 0]
    v = torch.linalg.solve_triangular(gp["L"], ks, upper=False)
    var = (sv[..., 0] - torch.sum(torch.square(v), dim=-2)).clamp(min=1e-12)
    # d mu_std / d a = sum_i alpha_i mask_i dk/dr * (a - x_i) / (ls^2 r)
    dkdr = -(5.0 / 3.0) * sv * r * (1.0 + SQRT5 * r) * e      # (*B, n, N)
    coef = (gp["alpha"] * gp["mask"])[..., :, None] * dkdr / (
        r.clamp(min=1e-12) * ls * ls)                          # (*B, n, N)
    dmu_std = torch.einsum("...nN,...nNd->...Nd", coef, -diff)
    y_sigma = gp["y_sigma"][..., None]
    return (mu_std * y_sigma + gp["y_mu"][..., None],
            torch.sqrt(var) * y_sigma,
            dmu_std * y_sigma[..., None])
