"""Hybrid acquisition function — Eq. (7)-(12) + adaptive weight schedules.
Counterpart of ``repro/core/acquisition.py``.

alpha(a) = lam_base*(EI + UCB) - lam_g*||grad mu|| - lam_p*penalty
(Alg. 1 line 10: lam_base multiplies both utility-driven terms; lam_p is
constant over the run, lam_base/lam_g decay exponentially.)

One call scores a fixed-shape candidate block (dense grid +
feasibility-boundary + incumbent-local slots) for every scenario at once,
then runs the projected-gradient refinement as a Python loop. The block
scoring takes the block's whole posterior (mean, sigma and mean
gradient) from one launch of the ``matern_posterior`` kernel. The
refinement moves one point per scenario and differentiates through
sigma and the mean gradient, so it stays the differentiable torch
expression of ``gp.posterior_with_grad_batch``, as in the reference.

Every array here carries a leading scenario axis ``S`` (the reference's
``vmap``); the single-scenario :func:`maximize` runs with ``S = 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import gp as gpm
from repro_torch.core import torch_cost
from repro_torch.core.surrogate import GPSurrogate
from repro_torch.kernels.matern_score.ops import matern_posterior

F32 = torch.float32
SIGMA_FLOOR = 1e-9      # EI guard: sigma -> 0 must not NaN/Inf the argmax
N_LOCAL = 45            # incumbent-local slots: 5 layer offsets x 9 powers
REFINE_STEPS = 25       # projected-gradient refinement (shared by the
REFINE_LR = 0.02        # sequential and batched engines — Eq. 12)


@dataclasses.dataclass(frozen=True)
class AcqWeights:
    lam_base0: float = 1.0
    lam_baseT: float = 0.2
    lam_g0: float = 0.3
    lam_gT: float = 0.02
    lam_p: float = 2.0
    beta: float = 2.0                 # UCB exploration factor


def schedule(w0: float, wT: float, t: float) -> float:
    """Exponential decay: w(t) = w0 * (wT/w0)^t, t in [0,1] (§5.2)."""
    if w0 <= 0.0:
        return 0.0
    return float(w0 * (wT / w0) ** t)


def expected_improvement(mu, sigma, best):
    sigma = sigma.clamp(min=SIGMA_FLOOR)
    z = (mu - best) / sigma
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf


def ucb(mu, sigma, beta):
    return mu + beta * sigma


def _lane(v, like):
    """A per-scenario value (Python scalar, or shape ``(*B,)``) viewed to
    broadcast against ``like`` of shape ``(*B, N)``."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[..., None] if v.ndim else v


def _combine(post, best_feasible, penalties, lam_base, lam_g, lam_p, beta,
             y_scale):
    mu, sigma, g = post
    bf = _lane(best_feasible, mu)
    ys = _lane(y_scale, mu)
    # safe norm: d||g||/dg at g=0 is NaN otherwise (differentiated again
    # during acquisition refinement)
    gn = torch.sqrt(torch.sum(torch.square(g), dim=-1) + 1e-12) / ys
    ei = expected_improvement(mu, sigma, bf) / ys
    ub = (ucb(mu, sigma, beta) - bf) / ys
    return (_lane(lam_base, mu) * (ei + ub) - _lane(lam_g, mu) * gn
            - lam_p * penalties)


def hybrid_scores(gp, cand, best_feasible, penalties, lam_base, lam_g,
                  lam_p, beta, y_scale, surrogate=None):
    """Vectorized hybrid acquisition over candidates, differentiable in
    ``cand``.

    cand: (*B, N, 2); penalties: (*B, N) raw constraint violations
    (Eq. 11); best_feasible, lam_base, lam_g, y_scale: per scenario.
    EI/UCB/grad terms operate on the standardized scale (divide by the
    GP's y std) so the weights are problem-scale independent.
    ``surrogate`` dispatches the posterior through a pluggable
    :class:`repro_torch.core.surrogate.Surrogate`; ``None`` is the exact
    GP.
    """
    if surrogate is None:
        post = gpm.posterior_with_grad_batch(gp, cand)
    else:
        post = surrogate.posterior_with_grad(gp, cand)
    return _combine(post, best_feasible, penalties, lam_base, lam_g, lam_p,
                    beta, y_scale)


def block_posterior(gp, cand, surrogate=None):
    """Posterior ``(mu, sigma, dmu)`` of a candidate block
    ``cand (S, N, 2)`` for an exact GP: one ``matern_posterior`` launch
    (its plain version for CPU tensors). Not differentiable in ``cand``.
    Other surrogates use their own posterior."""
    if surrogate is not None and not isinstance(surrogate, GPSurrogate):
        return surrogate.posterior_with_grad(gp, cand)
    theta = gp["theta"]
    return matern_posterior(
        cand.contiguous(), gp["x"].contiguous(), gp["alpha"].contiguous(),
        gp["mask"].to(F32).contiguous(), gp["L"],
        torch.exp(theta["log_ls"]).contiguous(),
        torch.exp(theta["log_sv"]).contiguous(), gp["y_mu"].contiguous(),
        gp["y_sigma"].contiguous())


def block_scores(gp, cand, best_feasible, penalties, lam_base, lam_g, lam_p,
                 beta, y_scale, surrogate=None):
    """:func:`hybrid_scores` of a whole candidate block, its posterior
    from the kernel (:func:`block_posterior`)."""
    return _combine(block_posterior(gp, cand, surrogate), best_feasible,
                    penalties, lam_base, lam_g, lam_p, beta, y_scale)


def candidate_grid(n: int = 64) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, n)
    g = np.stack(np.meshgrid(xs, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    return g


def local_candidates(problem, incumbent: Optional[np.ndarray],
                     n_power: int = 9) -> np.ndarray:
    """Neighborhood of the incumbent: +-2 layers x a power sweep."""
    if incumbent is None:
        return np.zeros((0, 2))
    l0, p0 = problem.denormalize(incumbent)
    out = []
    for dl in (-2, -1, 0, 1, 2):
        l = int(np.clip(l0 + dl, 1, problem.L))
        for p in np.linspace(max(problem.p_min, p0 - 0.1),
                             min(problem.p_max, p0 + 0.1), n_power):
            out.append(problem.normalize(l, float(p)))
    return np.array(out)


def local_candidates_dev(params, incumbent, has_incumbent, fill):
    """Device mirror of :func:`local_candidates`: a ``(*B, N_LOCAL, 2)``
    block of +-2 layer x 9 power neighbors of each scenario's incumbent
    ``(*B, 2)``, or ``fill`` duplicates where ``has_incumbent (*B,)`` is
    False."""
    l0, p0 = torch_cost.denormalize(params, incumbent)
    lo = torch.maximum(params["p_min"], p0 - 0.1)
    hi = torch.minimum(params["p_max"], p0 + 0.1)
    steps = torch.arange(9, dtype=F32, device=incumbent.device) / 8.0
    ps = lo[..., None] + (hi - lo)[..., None] * steps         # (*B, 9)
    l_max = params["n_layers"].long()
    blocks = []
    for dl in (-2, -1, 0, 1, 2):
        l = torch.minimum((l0 + dl).clamp(min=1), l_max)
        blocks.append(torch_cost.normalize(
            params, l[..., None].expand(ps.shape), ps))
    loc = torch.cat(blocks, dim=-2)                           # (*B, 45, 2)
    has = torch.as_tensor(has_incumbent, device=loc.device)
    return torch.where(has[..., None, None], loc, fill.expand(loc.shape))


def assemble_candidates_dev(params, grid, boundary, incumbent,
                            has_incumbent, constraint_aware: bool):
    """Device mirror of :func:`assemble_candidates` for a scenario stack:
    ``grid (G,2)`` is shared; ``boundary (*B, L, 2)`` is the per-scenario
    feasibility-boundary block pre-padded with ``grid[0]`` on the host.
    Returns ``(*B, G + L + N_LOCAL, 2)``."""
    lead = boundary.shape[:-2]
    fill = grid[0]
    if constraint_aware:
        loc = local_candidates_dev(params, incumbent, has_incumbent, fill)
    else:
        loc = fill.expand(lead + (N_LOCAL, 2))
    return torch.cat([grid.expand(lead + grid.shape), boundary, loc],
                     dim=-2)


def assemble_candidates(problem, grid: np.ndarray,
                        incumbent: Optional[np.ndarray],
                        constraint_aware: bool,
                        boundary: Optional[np.ndarray] = None,
                        l_pad: Optional[int] = None) -> np.ndarray:
    """Fixed-shape candidate block: (len(grid) + l_pad + N_LOCAL, 2).

    Unused boundary/local slots are filled with ``grid[0]`` duplicates so
    the argmax is unchanged (first occurrence wins) while the shape stays
    constant across iterations and scenarios. ``boundary`` takes
    precomputed feasibility-boundary candidates. ``l_pad`` sizes the
    boundary block to a batch-wide ``L_max`` (default: this problem's own
    L).
    """
    fill = grid[:1]
    bpad = np.repeat(fill, problem.L if l_pad is None else l_pad, axis=0)
    loc = np.repeat(fill, N_LOCAL, axis=0)
    if constraint_aware:
        b = problem.boundary_candidates() if boundary is None else boundary
        if len(b):
            bpad[:len(b)] = b[:problem.L]
        if incumbent is not None:
            loc = local_candidates(problem, incumbent)
    return np.concatenate([grid, bpad, loc], axis=0)


def _maximize_core(gp, params, cand, best_feasible, lam_base, lam_g, lam_p,
                   beta, refine_lr, refine_steps, penalties=None,
                   surrogate=None):
    """Block argmax + projected-gradient refinement, for S scenarios.

    ``gp``/``params`` leaves and ``cand (S, N, 2)``, ``best_feasible``,
    ``lam_base``, ``lam_g`` carry a leading S axis; ``lam_p``, ``beta``
    and ``refine_lr`` are shared scalars. Returns ``(best_a (S, 2),
    best_score (S,), block_scores (S, N))``. The penalty at the moved
    point is re-evaluated analytically each step (treated as locally
    constant for the gradient). Lanes never mix: the gradient of the
    per-lane sum is each lane's own gradient.
    """
    y_scale = gp["y_sigma"]
    with torch.no_grad():
        if penalties is None:
            penalties = torch_cost.penalty(params, cand)
        scores = block_scores(gp, cand, best_feasible, penalties, lam_base,
                              lam_g, lam_p, beta, y_scale, surrogate)
        # first maximum wins and NaN counts as the maximum, as jnp.argmax
        idx = torch.argmax(scores, dim=-1)
        a0 = torch.gather(cand, -2, idx[:, None, None].expand(-1, 1, 2))[:, 0]

    def score1(a):
        pen = torch_cost.penalty(params, a.detach())
        return hybrid_scores(gp, a[:, None], best_feasible, pen[:, None],
                             lam_base, lam_g, lam_p, beta, y_scale,
                             surrogate)[:, 0]

    def value_and_grad(a):
        with torch.enable_grad():
            a = a.detach().requires_grad_(True)
            s = score1(a)
            (g,) = torch.autograd.grad(s.sum(), a)
        return s.detach(), g

    # each visited point is scored exactly once: the loop body evaluates
    # score+gradient together, and the last moved point is scored after
    # the loop. best_s starts at -inf: the first pass scores a0 itself
    a = a0
    best_a = a0
    best_s = torch.full(a0.shape[:1], -math.inf, dtype=F32,
                        device=a0.device)
    alive = torch.ones(a0.shape[:1], dtype=torch.bool, device=a0.device)
    for _ in range(refine_steps):
        s, g = value_and_grad(a)
        better = alive & (s > best_s)
        best_a = torch.where(better[:, None], a, best_a)
        best_s = torch.where(better, s, best_s)
        ok = alive & torch.all(torch.isfinite(g), dim=-1)
        a = torch.where(ok[:, None], (a + refine_lr * g).clamp(0.0, 1.0), a)
        alive = ok
    with torch.no_grad():
        s_f = score1(a)
    better = alive & (s_f > best_s)
    return (torch.where(better[:, None], a, best_a),
            torch.where(better, s_f, best_s), scores)


def maximize_batch(gps, params_b, cand_b, best_feasible_b, lam_base_b,
                   lam_g_b, lam_p, beta, refine_lr, refine_steps,
                   surrogate=None):
    """Maximize S scenarios' acquisitions at once. Every ``*_b`` argument
    and the ``gps``/``params_b`` leaves carry a leading S axis; lam_p,
    beta and refine_lr are shared scalars. Returns
    ``(best_a (S,2), best_s (S,))``."""
    a, s, _ = _maximize_core(gps, params_b, cand_b, best_feasible_b,
                             lam_base_b, lam_g_b, lam_p, beta, refine_lr,
                             refine_steps, surrogate=surrogate)
    return a, s


def maximize(gp, problem, weights: AcqWeights, t_norm: float,
             best_feasible: float, grid: np.ndarray,
             incumbent: Optional[np.ndarray] = None,
             refine_steps: int = REFINE_STEPS,
             refine_lr: float = REFINE_LR,
             boundary: Optional[np.ndarray] = None) -> np.ndarray:
    """argmax over dense grid + feasibility-boundary + incumbent-local
    candidates, then projected-gradient refinement of the continuous
    (power) coordinate, for one scenario on the device of ``gp``."""
    device = gp["x"].device
    lam_base = schedule(weights.lam_base0, weights.lam_baseT, t_norm)
    lam_g = schedule(weights.lam_g0, weights.lam_gT, t_norm)
    cand = assemble_candidates(problem, grid, incumbent, weights.lam_p > 0,
                               boundary=boundary)
    params = problem.device_params(device=device)

    def lane(v):
        return torch.as_tensor([v], dtype=F32, device=device)

    gp1 = gpm.take_lanes(gp, None)           # add the S = 1 lane axis
    params1 = {k: v[None] for k, v in params.items()}
    best_a, _, _ = _maximize_core(
        gp1, params1, torch.as_tensor(cand).to(device, F32)[None],
        lane(best_feasible), lane(lam_base), lane(lam_g), weights.lam_p,
        weights.beta, refine_lr, refine_steps)
    return best_a[0].cpu().double().numpy()
