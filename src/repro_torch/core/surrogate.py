"""Pluggable surrogate models behind one small protocol. Counterpart of
``repro/core/surrogate.py``.

* :class:`GPSurrogate` — the exact zero-mean Matérn-5/2 GP of
  ``core/gp.py``; the default. The acquisition scores candidate blocks of
  an exact GP through the ``matern_posterior`` kernel.
* :class:`RandomFeatureSurrogate` — Matérn-5/2 random Fourier features +
  closed-form Bayesian linear regression: no Adam/MLL optimization at all
  (``fit`` is one D x D Cholesky). Its basis is drawn by host numpy from
  the same generator as the reference, so both packages use identical
  features.

Conventions shared by every implementation:

* ``fit``/``fit_from`` are batched (leading S lane axis on ``data``,
  ``theta0`` and ``prior``) and return ``(model, steps)`` where
  ``steps (S,) int32`` is the per-lane iterative-fit cost (0 for
  closed-form fits).
* ``posterior_with_grad(model, A)`` takes models and points with the same
  leading lane shape (``A (*B, N, d)``) and returns
  ``(mu (*B, N), sigma (*B, N), dmu (*B, N, d))`` on the raw utility
  scale. The reference takes one lane and ``vmap``s; here the lane axis
  is written out.
* The model is a plain dict with at least ``theta`` (the warm-start
  carry — same leaves as :func:`gp.init_theta`) and ``y_sigma``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import gp as gpm

F32 = torch.float32


@runtime_checkable
class Surrogate(Protocol):
    """What the BO engines need from a surrogate family (see module
    docstring for the batching/shape conventions)."""

    name: str

    def init_theta(self, shape=(), device="cuda") -> dict:
        """Cold-start hyperparameter leaves (the warm-start carry) for
        lane shape ``shape``."""
        ...

    def fit(self, data, prior=None):
        """Batched cold fit -> ``(model, steps (S,) int32)``."""
        ...

    def fit_from(self, data, theta0, prior=None):
        """Batched warm refit from per-lane ``theta0`` ->
        ``(model, steps)``."""
        ...

    def posterior_with_grad(self, model, A):
        """``A (*B, N, d) -> (mu, sigma, dmu)``, raw scale."""
        ...


@dataclasses.dataclass(frozen=True)
class GPSurrogate:
    """The exact Matérn-5/2 GP (``core/gp.py``) behind the protocol:
    every method calls the ``gp`` functions the engines call directly."""

    cfg: gpm.GPConfig = gpm.GPConfig()

    name = "gp"

    def init_theta(self, shape=(), device="cuda") -> dict:
        return gpm.init_theta(self.cfg, shape, device)

    def fit(self, data, prior=None):
        s = data["y"].shape[0]
        model = gpm.fit_batch(data, self.cfg, prior)
        return model, torch.full((s,), self.cfg.fit_steps, dtype=torch.int32,
                                 device=data["y"].device)

    def fit_from(self, data, theta0, prior=None):
        c = self.cfg
        return gpm._fit_core_from(data, c, theta0, c.warm_steps, c.warm_gtol,
                                  prior=prior)

    def posterior_with_grad(self, model, A):
        return gpm.posterior_with_grad_batch(model, A)


@lru_cache(maxsize=32)
def _rff_basis(n_features: int, seed: int, dim: int):
    """Fixed Matérn-5/2 spectral sample (host numpy, the reference's
    generator and draws).

    The Matérn-nu spectral density is a multivariate t with 2*nu dof:
    ``w = z * sqrt(2 nu / u)`` with ``z ~ N(0, I)``, ``u ~ chi2_{2 nu}``
    (nu = 5/2 here), divided by the lengthscale at evaluation time.
    """
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n_features, dim))
    u = rng.chisquare(5.0, n_features)
    w = z * np.sqrt(5.0 / u)[:, None]
    b = rng.uniform(0.0, 2.0 * np.pi, n_features)
    return w.astype(np.float32), b.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RandomFeatureSurrogate:
    """Random-Fourier-feature Bayesian linear regression (Matérn-5/2).

    ``phi(x) = sqrt(2 sv / D) cos(W x / ls + b)`` with ``W`` drawn once
    from the Matérn-5/2 spectral density; the posterior over feature
    weights is conjugate-normal, so the "fit" is a single D x D Cholesky
    (``A = Phi^T Phi + nv I``) — no hyperparameter optimization.
    """

    n_features: int = 512
    seed: int = 0
    cfg: gpm.GPConfig = gpm.GPConfig()

    name = "rff"

    def init_theta(self, shape=(), device="cuda") -> dict:
        return gpm.init_theta(self.cfg, shape, device)

    def _basis(self, like, dim: int):
        w0, b = _rff_basis(self.n_features, self.seed, dim)
        return (torch.as_tensor(w0, device=like.device),
                torch.as_tensor(b, device=like.device))

    def _fit_lanes(self, data, theta, prior):
        y_std, y_mu, y_sigma = gpm._standardize(data["y"], data["mask"],
                                                prior)
        w0, b = self._basis(y_std, data["x"].shape[-1])
        ls = torch.exp(theta["log_ls"])[..., None, None]
        sv = torch.exp(theta["log_sv"])[..., None, None]
        nv = torch.exp(theta["log_nv"]) + self.cfg.jitter
        scale = torch.sqrt(2.0 * sv / self.n_features)
        proj = data["x"] @ (w0.T / ls) + b                         # (*B, m, D)
        phi = scale * torch.cos(proj) * data["mask"][..., :, None]
        eye = torch.eye(self.n_features, dtype=F32, device=y_std.device)
        A = phi.transpose(-1, -2) @ phi + nv[..., None, None] * eye
        L = gpm.cholesky(A)
        rhs = (phi.transpose(-1, -2) @ y_std[..., None])[..., 0]
        coef = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        return dict(theta=theta, coef=coef, L=L, y_mu=y_mu, y_sigma=y_sigma)

    def fit(self, data, prior=None):
        s = data["y"].shape[0]
        return self.fit_from(data, self.init_theta((s,), data["y"].device),
                             prior)

    @torch.no_grad()
    def fit_from(self, data, theta0, prior=None):
        s = data["y"].shape[0]
        model = self._fit_lanes(data, theta0, prior)
        return model, torch.zeros((s,), dtype=torch.int32,
                                  device=data["y"].device)

    def posterior_with_grad(self, model, A):
        theta = model["theta"]
        w0, b = self._basis(A, A.shape[-1])
        ls = torch.exp(theta["log_ls"])[..., None, None]
        sv = torch.exp(theta["log_sv"])[..., None, None]
        nv = (torch.exp(theta["log_nv"]) + self.cfg.jitter)[..., None]
        w = w0 / ls                                                # (*B, D, d)
        proj = A @ w.transpose(-1, -2) + b                         # (*B, N, D)
        scale = torch.sqrt(2.0 * sv / self.n_features)
        phi = scale * torch.cos(proj)
        mu_std = (phi @ model["coef"][..., None])[..., 0]          # (*B, N)
        # latent var: nv * phi A^-1 phi^T == nv |L^-1 phi^T|^2
        v = torch.linalg.solve_triangular(model["L"], phi.transpose(-1, -2),
                                          upper=False)
        var = (nv * torch.sum(torch.square(v), dim=-2)).clamp(min=1e-12)
        # analytic mean gradient: d phi / d a = -scale sin(proj) W
        dmu_std = ((-scale * torch.sin(proj))
                   * model["coef"][..., None, :]) @ w
        y_sigma = model["y_sigma"][..., None]
        return (mu_std * y_sigma + model["y_mu"][..., None],
                torch.sqrt(var) * y_sigma,
                dmu_std * y_sigma[..., None])


def default_surrogate(gp_cfg: gpm.GPConfig) -> GPSurrogate:
    """The engine default: the exact GP at the given config."""
    return GPSurrogate(gp_cfg)


def resolve(surrogate, gp_cfg: gpm.GPConfig):
    """``None`` -> the default exact GP."""
    return default_surrogate(gp_cfg) if surrogate is None else surrogate
