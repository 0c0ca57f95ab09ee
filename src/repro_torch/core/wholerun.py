"""Whole-run Bayes-Split-Edge: Algorithm 1's bookkeeping on the device.
Counterpart of ``repro/core/wholerun.py``.

The eval ledger, probe queue, seen-set, early-stop masking and
feasible-only GP filtering live in fixed-shape tensors with a leading
lane axis, one lane per scenario. Each loop step performs exactly one
evaluation per live lane — the front of its discrete-probe queue or the
acquisition argmax — so every scenario's eval sequence is the host
engines'. GP refits are warm-started from the previous iteration's
hyperparameters (``gp._fit_core_from``: Adam stops per lane once the MLL
gradient norm falls below ``GPConfig.warm_gtol``); ``warm_start=False``
keeps the cold fits.

The reference compiles the loop into one ``lax.while_loop``; here the
loop is a host ``while`` over eager torch. Before every body step one
host read (:func:`_read`) fetches what the reference's ``cond`` and its
``lax.cond`` branches decide on — live lanes, the largest dataset, and
the ``any_unseeded``/``need_acq``/``all_cold`` flags — so iterations in
which every live lane drains its probe queue launch nothing on the
GP/acquisition path. The fit and the acquisition run on chunks of exactly
:data:`LANE_WIDTH` lanes, so a lane's numbers never depend on how many
lanes share the batch; a chunk's block scoring is one
``matern_posterior`` launch (``acquisition._maximize_core``) at the
phase's dataset bucket ``n``.

The lane axis is architecture-heterogeneous: per-layer surfaces and the
boundary candidate block pad to the batch-wide ``l_pad`` and every layer
clip uses the lane's own ``params["n_layers"]``. With ``compact=True``
(the default) the run is a short host-driven sequence of phases, each
exiting once the live-lane count falls to half the lane capacity; the
host loop gathers the surviving lanes into a dense prefix of the next
power-of-two lane count and flushes retired lanes' results into their
scenario rows. Every lane's trajectory is a function of its own state
only, so cold compacted runs equal the uncompacted program bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gp as gpm
from repro_torch.core import surrogate as smod
from repro_torch.core import torch_cost as tc
from repro_torch.core.acquisition import (REFINE_LR, REFINE_STEPS,
                                          AcqWeights, _maximize_core,
                                          assemble_candidates_dev,
                                          candidate_grid)
from repro_torch.core.batch_bo import Scenario
from repro_torch.core.bo import BOResult, _init_grid
from repro_torch.core.engine_config import EngineConfig, resolve_config
from repro_torch.core.priorbank import PriorBank, stage_prior
from repro_torch.device import resolve_device

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class WholeRunConfig:
    """Static shape/flag configuration of the loop."""
    n_init: int
    n_max_repeat: int
    budget_max: int              # eval-ledger length (max budget in batch)
    l_pad: int                   # batch-wide padded layer count (L_max);
                                 # per-scenario clips use params["n_layers"]
    constraint_aware: bool
    gp_feasible_only: bool
    use_schedules: bool
    warm_start: bool
    gp: gpm.GPConfig
    # divergence quarantine: lanes with non-finite GP *data* always fault
    # (impossible in healthy runs, so the default detector keeps every
    # healthy run unchanged); with fault_on_divergence the detector also
    # faults lanes whose refit carry / chosen point went non-finite
    fault_on_divergence: bool = False
    # pluggable surrogate (None -> the exact GP) and the transfer-learned
    # prior: with use_prior the per-lane (prior_mu, prior_n0) state feeds
    # the fit's mean-prior shrinkage and bank-hit lanes enter seeded with
    # their banked theta
    surrogate: Optional[smod.Surrogate] = None
    use_prior: bool = False


# the host loop's device-to-host reads and the body's acquisition
# iterations since import; an engine reports its run's share in
# ``lane_stats()``
_counts = dict(host_reads=0, acq_iters=0)


def _read(t: torch.Tensor) -> list:
    """One device-to-host read of the loop's control values."""
    _counts["host_reads"] += 1
    return t.tolist()


def _host(t: torch.Tensor) -> np.ndarray:
    _counts["host_reads"] += 1
    return t.cpu().numpy()


def _sched(w0, wT, t):
    """Device mirror of acquisition.schedule: w0 * (wT/w0)^t, 0 if w0<=0."""
    safe = torch.where(w0 > 0.0, w0, torch.ones_like(w0))
    return torch.where(w0 > 0.0, w0 * (wT / safe) ** t, torch.zeros_like(t))


def _sel(pred, new, old):
    """Per-lane select with the (S,) predicate broadcast over trailing
    dims; applied leaf by leaf to (nested) dicts."""
    if isinstance(new, dict):
        return {k: _sel(pred, new[k], old[k]) for k in new}
    p = pred.reshape(pred.shape + (1,) * (new.ndim - pred.ndim))
    return torch.where(p, new, old)


def _next_pow2(n: int) -> int:
    s = 1
    while s < n:
        s *= 2
    return s


def _init_state(s: int, cfg: WholeRunConfig, device, dim: int = 2):
    m, t = cfg.gp.max_points, cfg.budget_max
    q = t + 2                    # probe queue can never outgrow the budget

    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return dict(
        # GP dataset (feasible-only gated mirror of ScenarioState)
        x=z(s, m, dim), y=z(s, m), mask=z(s, m, dtype=torch.bool),
        n_pts=z(s, dtype=I32),
        # eval ledger
        ev_u=z(s, t), ev_acc=z(s, t), ev_feas=z(s, t, dtype=torch.bool),
        ev_trace=z(s, t), ev_l=full((s, t), -1, I32), ev_pr=z(s, t),
        n=z(s, dtype=I32),
        # incumbent
        best_a=z(s, dim), best_u=full((s,), -float("inf"), F32),
        has_best=z(s, dtype=torch.bool), inc_layer=full((s,), -1, I32),
        # discrete-probe queue (Alg. 1 mixed-integer local search)
        probe_q=z(s, q, dim), probe_n=z(s, dtype=I32),
        # early-stop masking
        n_c=z(s, dtype=I32), active=torch.ones(s, dtype=torch.bool,
                                               device=device),
        # `seeded`: the lane's warm-start carry holds a fit (False until
        # its first post-init body iteration); `gen`: bumped by every
        # admission scatter
        seeded=z(s, dtype=torch.bool), gen=z(s, dtype=I32),
        # divergence quarantine: raised when a lane's data goes non-finite
        fault=z(s, dtype=torch.bool),
        # warm-start carry + fit-cost accounting
        theta=smod.resolve(cfg.surrogate, cfg.gp).init_theta((s,), device),
        fit_steps=z(s, dtype=I32), fit_calls=z(s, dtype=I32),
        # transfer-learned mean prior: zeros (the default, and every bank
        # miss) reproduce the prior-free arithmetic bit for bit
        prior_mu=z(s), prior_n0=z(s),
    )


# -- per-lane Algorithm-1 bookkeeping, written over the lane axis ------------

def _lanes(t):
    return torch.arange(t.shape[0], device=t.device)


def _put(arr, idx, val):
    """``arr[s, idx[s]] = val[s]`` for every lane s, out of place; an
    index past the end drops the write, as JAX's ``.at[].set`` does."""
    t = arr.shape[1]
    i = idx.clamp(max=t - 1).long()
    rows = _lanes(arr)
    ok = (idx < t).reshape((-1,) + (1,) * (val.ndim - 1))
    out = arr.clone()
    out[rows, i] = torch.where(ok, val.to(arr.dtype), arr[rows, i])
    return out


def _observe(st, a, params, cfg: WholeRunConfig):
    """One oracle evaluation per lane: ledger append, incumbent update,
    gated GP dataset append, seen-key record (mirror of
    ScenarioState.observe)."""
    li, p = tc.denormalize(params, a)
    u, acc, feas = tc.utility(params, li, p)
    n = st["n"]
    newbest = feas & (u > st["best_u"])
    best_u = torch.where(newbest, u, st["best_u"])
    st = dict(st)
    st["best_u"] = best_u
    st["best_a"] = torch.where(newbest[:, None], a, st["best_a"])
    st["has_best"] = st["has_best"] | newbest
    st["ev_u"] = _put(st["ev_u"], n, u)
    st["ev_acc"] = _put(st["ev_acc"], n, acc)
    st["ev_feas"] = _put(st["ev_feas"], n, feas)
    st["ev_trace"] = _put(st["ev_trace"], n, torch.where(
        torch.isfinite(best_u), best_u, torch.zeros_like(best_u)))
    st["ev_l"] = _put(st["ev_l"], n, li)
    st["ev_pr"] = _put(st["ev_pr"], n, tc.seen_key(p))
    add = feas if cfg.gp_feasible_only else torch.ones_like(feas)
    k = st["n_pts"].clamp(max=cfg.gp.max_points - 1)
    rows = _lanes(a)
    st["x"] = _put(st["x"], k, torch.where(add[:, None], a,
                                           st["x"][rows, k.long()]))
    st["y"] = _put(st["y"], k, torch.where(add, u, st["y"][rows, k.long()]))
    st["mask"] = _put(st["mask"], k, st["mask"][rows, k.long()] | add)
    st["n_pts"] = st["n_pts"] + (
        add & (st["n_pts"] < cfg.gp.max_points)).to(I32)
    st["n"] = n + 1
    return st


def _push_probes(st, params, cfg: WholeRunConfig):
    """Queue +-1 layer neighbors of a new incumbent layer at the analytic
    min-feasible power (mirror of ScenarioState.push_probes)."""
    if not cfg.constraint_aware:
        return st
    l_star, p_star = tc.denormalize(params, st["best_a"])
    do = st["has_best"] & (l_star != st["inc_layer"])
    st = dict(st)
    st["inc_layer"] = torch.where(do, l_star.to(I32), st["inc_layer"])
    t = st["ev_l"].shape[1]
    q = st["probe_q"].shape[1]
    live = torch.arange(t, device=do.device)[None, :] < st["n"][:, None]
    # the lane's OWN layer count, not the batch-wide padded L_max: a
    # probe must never land on a padded tail split of a shorter arch
    l_hi = params["n_layers"].long()
    for dl in (1, -1):
        l = l_star + dl
        ok = do & (l >= 1) & (l <= l_hi)
        lc = torch.minimum(l.clamp(min=1), l_hi)
        a = tc.project_feasible(params, tc.normalize(params, lc, p_star))
        lp, pp = tc.denormalize(params, a)
        seen = torch.any(live & (st["ev_l"] == lp[:, None])
                         & (st["ev_pr"] == tc.seen_key(pp)[:, None]), dim=1)
        enq = ok & ~seen & (st["probe_n"] < q)
        qi = st["probe_n"].clamp(max=q - 1)
        old = st["probe_q"][_lanes(a), qi.long()]
        st["probe_q"] = _put(st["probe_q"], qi,
                             torch.where(enq[:, None], a, old))
        st["probe_n"] = st["probe_n"] + enq.to(I32)
    return st


def _step(st, a, params, budget, cfg: WholeRunConfig):
    """Observation + probe push + incumbent-repeat early stop
    (Alg. 1 lines 14-21; mirror of ScenarioState.step)."""
    li_n, p_n = tc.denormalize(params, a)
    li_b, p_b = tc.denormalize(params, st["best_a"])
    same = st["has_best"] & (li_n == li_b) & (p_n == p_b)
    st = _observe(st, a, params, cfg)
    st = _push_probes(st, params, cfg)
    n_c = torch.where(same, st["n_c"] + 1, torch.zeros_like(st["n_c"]))
    st["n_c"] = n_c
    st["active"] = (st["n"] < budget) & (n_c < cfg.n_max_repeat)
    return st


def _one_init(st, params, pts, budget, cfg: WholeRunConfig):
    """The init design of every lane: ``pts (S, n_init, 2)``."""
    for j in range(cfg.n_init):
        st = _observe(st, pts[:, j], params, cfg)
    st = _push_probes(st, params, cfg)
    st["active"] = st["n"] < budget
    return st


def _pen_static(params, grid, boundary):
    """Eq.-(11) penalties for the grid + boundary candidate slots depend
    only on the channel — computed once per run, not per iteration."""
    s = boundary.shape[0]
    return torch.cat([tc.penalty(params, grid.expand((s,) + grid.shape)),
                      tc.penalty(params, boundary)], dim=1)    # (S, G + L)


# -- the loop ----------------------------------------------------------------

_OUT_KEYS = ("ev_u", "ev_acc", "ev_feas", "ev_trace", "ev_l", "n",
             "best_a", "best_u", "has_best", "fit_steps", "fit_calls",
             "gen", "fault")


def _flags(st):
    """Everything the loop conditions and the body's branches read, in
    one host read: live lanes, the largest dataset (all lanes, and live
    lanes only), and the ``any_unseeded``/``need_acq``/``all_cold``
    flags of the reference's ``lax.cond`` branches."""
    act = st["active"]
    unseeded = torch.any(act & ~st["seeded"])
    v = _read(torch.stack([
        act.sum(dtype=I32), st["n_pts"].max(),
        torch.where(act, st["n_pts"], torch.zeros_like(st["n_pts"])).max(),
        unseeded.to(I32),
        (torch.any(act & (st["probe_n"] == 0)) | unseeded).to(I32),
        (~torch.any(act & st["seeded"])).to(I32)]))
    return dict(live=v[0], max_pts=v[1], max_live_pts=v[2],
                any_unseeded=bool(v[3]), need_acq=bool(v[4]),
                all_cold=bool(v[5]))


# the lane state the fit + acquisition read, besides the dataset
_ACQ_KEYS = ("prior_mu", "prior_n0", "theta", "seeded", "best_a",
             "has_best", "n", "ev_u", "best_u")
# lanes per fit + acquisition call. cuSOLVER's and cuBLAS's batched
# routines pick their algorithm by batch count, so a lane's fitted theta
# changes in its last bits with the number of lanes beside it (H100,
# torch 2.11, CUDA 12.8; chip_smoke.py's `lane_independence` line). The
# body therefore runs them on chunks of exactly this many lanes, padding
# a short chunk with copies of its first lane: a lane's numbers are then
# the same at any lane count, which compaction and shard packing need
LANE_WIDTH = 16


def _cat(parts):
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _by_width(fn, lanes: dict, s: int):
    """``fn`` of the lane-aligned dict ``lanes`` (``s`` lanes), taken
    over chunks of exactly :data:`LANE_WIDTH` lanes (the last padded
    with copies of its first lane); the per-lane outputs concatenated."""
    dev = lanes["budget"].device
    parts = []
    for c0 in range(0, s, LANE_WIDTH):
        rows = np.arange(c0, min(c0 + LANE_WIDTH, s))
        idx = np.concatenate([rows, np.full(LANE_WIDTH - rows.size,
                                            rows[0])])
        out = fn(gpm.take_lanes(lanes, torch.as_tensor(idx, device=dev)))
        parts.append(gpm.take_lanes(out, slice(0, rows.size)))
    return _cat(parts)


def _make_body(run_data, grid, wvec, cfg: WholeRunConfig, m: int):
    """One BO iteration over the whole lane batch at dataset bucket ``m``
    — the loop body shared by the single-dispatch program and the
    compacted phases. ``run_data`` carries the lane-aligned inputs:
    ``params``, ``boundary``, ``budget`` and the static penalty block
    ``pen``. ``body(st, flags)`` takes :func:`_flags` of ``st``."""
    params = run_data["params"]
    budget = run_data["budget"]
    s = budget.shape[0]
    surr = smod.resolve(cfg.surrogate, cfg.gp)

    def fit_and_maximize(ln, fl):
        """Fit + acquisition of one lane chunk ``ln`` (lane-aligned
        inputs, any lane count) -> theta, fit steps, chosen point."""
        lanes = ln["budget"].shape[0]
        data = dict(x=ln["x"], y=ln["y"], mask=ln["mask"])
        prior = (dict(mu0=ln["prior_mu"], n0=ln["prior_n0"])
                 if cfg.use_prior else None)
        # GP refits: cold on a lane's first fit, warm-started + adaptive
        # after; a batch mixing unseeded and seeded lanes pays both fits
        # and selects per lane (streaming admission boundaries only)
        if not cfg.warm_start or fl["all_cold"]:
            gp_b, steps = surr.fit(data, prior)
        elif fl["any_unseeded"]:
            gp_c, steps_c = surr.fit(data, prior)
            gp_w, steps_w = surr.fit_from(data, ln["theta"], prior)
            gp_b = _sel(ln["seeded"], gp_w, gp_c)
            steps = torch.where(ln["seeded"], steps_w, steps_c)
        else:
            gp_b, steps = surr.fit_from(data, ln["theta"], prior)

        p = ln["params"]
        cand_b = assemble_candidates_dev(p, grid, ln["boundary"],
                                         ln["best_a"], ln["has_best"],
                                         cfg.constraint_aware)
        live_ev = (torch.arange(cfg.budget_max, device=grid.device)[None, :]
                   < ln["n"][:, None])
        ev_min = torch.where(live_ev, ln["ev_u"],
                             torch.full_like(ln["ev_u"], float("inf"))
                             ).amin(dim=1)
        bf = torch.where(torch.isfinite(ln["best_u"]), ln["best_u"], ev_min)
        if cfg.use_schedules:
            t_norm = ((ln["n"] - cfg.n_init).to(F32)
                      / torch.clamp(ln["budget"] - 1, min=1))
        else:
            t_norm = torch.zeros((lanes,), dtype=F32, device=grid.device)
        lam_b = _sched(wvec["lam_base0"], wvec["lam_baseT"], t_norm)
        lam_g = _sched(wvec["lam_g0"], wvec["lam_gT"], t_norm)
        n_stat = ln["pen"].shape[1]
        pen_b = torch.cat([ln["pen"], tc.penalty(p, cand_b[:, n_stat:])],
                          dim=1)
        a_acq, _, _ = _maximize_core(
            gp_b, p, cand_b, bf, lam_b, lam_g, wvec["lam_p"],
            wvec["beta"], REFINE_LR, REFINE_STEPS, penalties=pen_b,
            surrogate=cfg.surrogate)
        return dict(theta=gp_b["theta"], steps=steps, a=a_acq)

    def body(st, fl):
        # iterations where every live lane drains its probe queue skip
        # the fit + acquisition (probes bypass the GP in the host engines
        # too); unseeded lanes always fit, so every lane's warm carry is
        # seeded by a cold fit of its own init design
        if fl["need_acq"]:
            _counts["acq_iters"] += 1
            ln = dict(run_data, **{k: st[k] for k in _ACQ_KEYS},
                      **gpm.slice_data(st, m))
            res = _by_width(lambda c: fit_and_maximize(c, fl), ln, s)
            theta, steps, a_acq = res["theta"], res["steps"], res["a"]
        else:
            theta = st["theta"]
            steps = torch.zeros((s,), dtype=I32, device=grid.device)
            a_acq = torch.zeros((s, 2), dtype=F32, device=grid.device)

        # probe-or-acquisition select + FIFO pop (probes bypass the GP,
        # matching ScenarioState.drain_probes' eval order)
        use_probe = st["probe_n"] > 0
        a_next = torch.where(use_probe[:, None], st["probe_q"][:, 0], a_acq)
        st2 = dict(st)
        st2["probe_q"] = torch.where(use_probe[:, None, None],
                                     torch.roll(st["probe_q"], -1, dims=1),
                                     st["probe_q"])
        st2["probe_n"] = st["probe_n"] - use_probe.to(I32)
        # a lane's warm carry advances only on ITS acquisition iterations
        # (plus its own first-iteration cold seed), so its theta
        # trajectory depends on its own eval sequence only
        upd = ~st["seeded"] | ~use_probe
        st2["theta"] = _sel(upd, theta, st["theta"])
        st2["fit_steps"] = st["fit_steps"] + torch.where(
            upd, steps, torch.zeros_like(steps))
        st2["fit_calls"] = st["fit_calls"] + upd.to(I32)
        st2["seeded"] = torch.ones_like(st["seeded"])
        st2 = _step(st2, a_next, params, budget, cfg)
        # divergence quarantine: a lane whose GP dataset went non-finite
        # freezes with `fault` raised (a retirement event for the phase
        # exits); healthy data is finite, so `bad` is all False
        bad = st["active"] & (
            torch.any(st["mask"] & ~torch.isfinite(st["y"]), dim=1)
            | torch.any(st["mask"] & ~torch.all(torch.isfinite(st["x"]),
                                                dim=-1), dim=1))
        if cfg.fault_on_divergence:
            bad = bad | (st["active"] & (
                (~gpm.theta_finite(theta) & upd)
                | ~torch.all(torch.isfinite(a_next), dim=1)))
        # freeze finished lanes (early-stop masking) + faulted lanes
        new = _sel(st["active"] & ~bad, st2, st)
        new["fault"] = st["fault"] | bad
        new["active"] = new["active"] & ~bad
        return new

    return body


def _final_bucket(cfg: WholeRunConfig) -> int:
    return gpm.bucket_size(min(cfg.budget_max, cfg.gp.max_points),
                           cfg.gp.max_points)


def _phases(cfg: WholeRunConfig) -> list:
    m_final = _final_bucket(cfg)
    return [b for b in gpm.DATASET_BUCKETS if b < m_final] + [m_final]


@torch.no_grad()
def whole_run(stacked, grid, wvec, cfg: WholeRunConfig):
    """Init design + every BO iteration for the whole lane batch, without
    compaction.

    The loop runs in dataset-bucket *phases* (16/32/48/64 rows, the
    ``gp.DATASET_BUCKETS`` of the host engines): within phase ``m`` the
    GP fits and posteriors take the first ``m`` rows of the padded
    dataset — exact w.r.t. the masked kernel — and the loop falls through
    to the next bucket once any lane outgrows it.

    Returns ``(outputs, n_iters)`` — the total body-step count feeds the
    live-lane occupancy accounting (every step computes all S lanes).
    """
    state, pen = _init_run_core(stacked, grid, cfg)
    run_data = dict(params=stacked["params"], boundary=stacked["boundary"],
                    budget=stacked["budget"], pen=pen)
    phases = _phases(cfg)
    it = 0
    for m in phases:
        body = _make_body(run_data, grid, wvec, cfg, m)
        while True:
            fl = _flags(state)
            ok = fl["live"] > 0 and it < cfg.budget_max
            if m != phases[-1]:        # fall through once a dataset
                ok = ok and fl["max_pts"] <= m        # outgrows m
            if not ok:
                break
            state = body(state, fl)
            it += 1
    out = {k: state[k] for k in _OUT_KEYS}
    # the final warm-start carry rides along for the prior bank's
    # retirement recording
    out["theta"] = state["theta"]
    return out, it


# -- lane-compaction phases (host-driven sequence) ---------------------------

def _apply_stacked_prior(state, stacked, cfg: WholeRunConfig):
    """Install the staged prior-bank payload into freshly initialized
    lanes: the per-lane mean prior always, and — on the warm-start path —
    the banked theta as the warm carry of hit lanes, which enter
    ``seeded`` so their first fit is a warm refit from the transferred
    hyperparameters. Miss lanes (and ``use_prior=False`` runs) keep the
    cold path bit for bit."""
    if not cfg.use_prior or "prior_n0" not in stacked:
        return state
    state = dict(state, prior_mu=stacked["prior_mu"].to(F32),
                 prior_n0=stacked["prior_n0"].to(F32))
    if cfg.warm_start:
        hit = stacked["bank_hit"]
        theta = {k: _sel(hit, stacked["theta0"][k].to(v.dtype), v)
                 for k, v in state["theta"].items()}
        state = dict(state, theta=theta, seeded=state["seeded"] | hit)
    return state


def _init_run_core(stacked, grid, cfg: WholeRunConfig):
    params = stacked["params"]
    s = stacked["budget"].shape[0]
    state = _one_init(_init_state(s, cfg, grid.device), params,
                      stacked["init_pts"], stacked["budget"], cfg)
    state = _apply_stacked_prior(state, stacked, cfg)
    return state, _pen_static(params, grid, stacked["boundary"])


@torch.no_grad()
def init_run(stacked, grid, cfg: WholeRunConfig):
    """The init design: returns the full-lane state plus the static
    penalty block (both lane-aligned, so the compaction gather permutes
    them together with ``params``/``boundary``)."""
    return _init_run_core(stacked, grid, cfg)


@torch.no_grad()
def admit_init(stacked, grid, cfg: WholeRunConfig, seed_theta: bool):
    """Admission staging: the init design plus (on the warm-start path)
    the cold seed of each admitted lane's GP carry — the cold fit of the
    init-design dataset (at the init bucket) that iteration 0 of the
    offline run performs, pulled forward to admission time so a
    long-lived server's body only ever pays warm refits. Seeded lanes
    enter the pool with ``seeded=True``. The seed fits run on chunks of
    :data:`LANE_WIDTH` lanes, as the body's fits do, so a lane's seed is
    the same however many requests are admitted with it."""
    state, pen = _init_run_core(stacked, grid, cfg)
    if seed_theta:
        surr = smod.resolve(cfg.surrogate, cfg.gp)
        m = gpm.bucket_size(min(cfg.n_init, cfg.gp.max_points),
                            cfg.gp.max_points)
        # bank-hit lanes seed with a warm refit FROM the banked theta
        # (installed by _apply_stacked_prior); misses pay the cold seed
        bank_warm = cfg.use_prior and cfg.warm_start and "bank_hit" in stacked
        lanes = dict(budget=stacked["budget"], theta=state["theta"],
                     prior_mu=state["prior_mu"], prior_n0=state["prior_n0"],
                     **gpm.slice_data(state, m))
        if bank_warm:
            lanes["hit"] = stacked["bank_hit"]

        def seed(ln):
            data = dict(x=ln["x"], y=ln["y"], mask=ln["mask"])
            prior = (dict(mu0=ln["prior_mu"], n0=ln["prior_n0"])
                     if cfg.use_prior else None)
            model_c, steps_c = surr.fit(data, prior)
            if not bank_warm:
                return dict(theta=model_c["theta"], steps=steps_c)
            model_w, steps_w = surr.fit_from(data, ln["theta"], prior)
            return dict(theta=_sel(ln["hit"], model_w["theta"],
                                   model_c["theta"]),
                        steps=torch.where(ln["hit"], steps_w, steps_c))

        res = _by_width(seed, lanes, stacked["budget"].shape[0])
        theta, steps = res["theta"], res["steps"]
        state = dict(
            state, theta=theta,
            fit_steps=state["fit_steps"] + steps,
            fit_calls=state["fit_calls"] + 1,
            seeded=torch.ones_like(state["seeded"]))
    return state, pen


@torch.no_grad()
def run_phase(run_data, state, it: int, grid, wvec, cfg: WholeRunConfig,
              m: int, last: bool):
    """One compaction phase: the loop body at dataset bucket ``m``,
    iterated until (a) every lane is done, (b) a live dataset outgrows
    the bucket, or (c) the live-lane count falls to half the lane
    capacity — then the host loop compacts and runs the next phase on
    fewer lanes. ``it`` is the global iteration counter carried across
    phases; returns ``(state, it)``."""
    s = run_data["budget"].shape[0]
    body = _make_body(run_data, grid, wvec, cfg, m)
    while True:
        fl = _flags(state)
        live = fl["live"]
        ok = live > 0 and it < cfg.budget_max
        # a LIVE dataset outgrowing m ends the phase: a retired lane's
        # stale dataset must not stop it at zero iterations
        if not last:
            ok = ok and fl["max_live_pts"] <= m
        if s > 1:                  # exit to compact once occupancy halves
            ok = ok and 2 * live > s
        if not ok:
            return state, it
        state = body(state, fl)
        it += 1


def gather_live_lanes(state, run_data, live: np.ndarray, s_next: int):
    """The compaction gather shared by the offline compaction loop and
    the streaming pool shrink: permute the surviving lanes (``live``,
    original row indices) into a dense prefix of a ``s_next``-lane
    layout — state AND lane-aligned inputs — padding with duplicates of
    the first survivor, which stay deactivated. Returns
    ``(state, run_data, keep)`` where ``keep`` is the row permutation
    the caller applies to its own host-side lane bookkeeping."""
    keep = np.concatenate([live, np.repeat(live[:1], s_next - live.size)])
    idx = torch.as_tensor(keep, device=state["n"].device)
    state = gpm.take_lanes(state, idx)
    run_data = gpm.take_lanes(run_data, idx)
    if live.size < s_next:       # pad duplicates stay frozen
        state = dict(state, active=state["active"] & (
            torch.arange(s_next, device=idx.device) < live.size))
    return state, run_data, keep


def _fresh_tail(state, k: int):
    """Zero the bookkeeping of every row past the first ``k``: resized
    pools pad with gathered duplicates of occupied rows, and a duplicate
    must not inherit its source's generation / fault / seed flags."""
    s = state["active"].shape[0]
    tail = torch.arange(s, device=state["active"].device) >= k
    return dict(state,
                active=state["active"] & ~tail,
                fault=state["fault"] & ~tail,
                seeded=state["seeded"] & ~tail,
                gen=torch.where(tail, torch.zeros_like(state["gen"]),
                                state["gen"]))


def resize_lanes(state, run_data, occ: np.ndarray, s_next: int):
    """Elastic pool resize — the compaction gather run in *either*
    direction: permute the occupied rows (``occ``, original indices)
    into a dense prefix of an ``s_next``-lane layout (state AND
    lane-aligned inputs). Tail rows (duplicates of the first occupant,
    or of row 0 when the pool is empty) come back deactivated with fresh
    generation/fault/seed bookkeeping, ready for an admission scatter.
    Returns ``(state, run_data)``; the caller permutes its host lane maps
    with ``occ`` itself."""
    if occ.size > s_next:
        raise ValueError(f"{occ.size} occupied lanes cannot fit a "
                         f"{s_next}-lane pool")
    src = np.zeros(s_next, np.int64)
    src[:occ.size] = occ
    idx = torch.as_tensor(src, device=state["n"].device)
    state = gpm.take_lanes(state, idx)
    run_data = gpm.take_lanes(run_data, idx)
    return _fresh_tail(state, int(occ.size)), run_data


# -- streaming admission (the streaming server drives these) -----------------

@torch.no_grad()
def stream_phase(run_data, state, it: int, live0: int, grid, wvec,
                 cfg: WholeRunConfig, m: int, last: bool):
    """One serving-loop phase: the loop body at dataset bucket ``m``,
    iterated until (a) every lane is done, (b) a live dataset outgrows
    the bucket, or (c) ANY lane retires (``live`` falls below the entry
    count ``live0``) — the lane-free event the admission queue waits on.
    Unlike :func:`run_phase` the iteration cap is per call (``it`` grows
    without bound across a stream's life; an active lane must retire
    within ``budget_max`` steps, which bounds each call instead)."""
    it0 = it
    body = _make_body(run_data, grid, wvec, cfg, m)
    while True:
        fl = _flags(state)
        live = fl["live"]
        ok = live > 0 and it - it0 < cfg.budget_max and live >= live0
        if not last:
            ok = ok and fl["max_live_pts"] <= m
        if not ok:
            return state, it
        state = body(state, fl)
        it += 1


def _lane_index(lanes, like):
    return torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                           device=like.device)


def _set_rows(arr, idx, val):
    out = arr.clone()
    out[idx] = val.to(arr.dtype)
    return out


def admit_lanes(state, run_data, new_state, new_run_data, lanes):
    """Admission scatter — the inverse of the compaction gather: write
    the first ``k = len(lanes)`` rows of a freshly initialized
    mini-batch (state AND lane-aligned inputs) into the given freed
    lanes of a running pool. The lane generation counter increments
    instead of being overwritten, so ledger snapshots remain
    attributable to one (lane, generation) occupant."""
    idx = _lane_index(lanes, state["n"])
    k = idx.shape[0]

    def put(big, new):
        if isinstance(big, dict):
            return {key: put(big[key], new[key]) for key in big}
        return _set_rows(big, idx, new[:k])

    gen = state["gen"].index_add(0, idx, torch.ones_like(idx, dtype=I32))
    state = dict(put(state, new_state), gen=gen)
    return state, put(run_data, new_run_data)


def retire_lanes(state, run_data, lanes):
    """Force-retire the given lanes (deactivate; the next phase exit /
    collect flushes them), installing the best-effort degraded answer
    for lanes that never found a feasible incumbent: the feasible
    projection of the search-space center (``torch_cost
    .fallback_answer``). ``fault`` clears so the flush path treats the
    lane as ordinarily retired."""
    idx = _lane_index(lanes, state["n"])
    params_rows = gpm.take_lanes(run_data["params"], idx)
    hb = state["has_best"][idx]
    a, u, feas = tc.fallback_answer(params_rows, state["best_a"][idx], hb)
    state = dict(state)
    state["best_a"] = _set_rows(state["best_a"], idx, a)
    state["best_u"] = _set_rows(state["best_u"], idx, torch.where(
        hb, state["best_u"][idx],
        torch.where(feas, u, torch.full_like(u, -float("inf")))))
    state["has_best"] = _set_rows(state["has_best"], idx, hb | feas)
    state["active"] = _set_rows(state["active"], idx,
                                torch.zeros_like(hb))
    state["fault"] = _set_rows(state["fault"], idx, torch.zeros_like(hb))
    return state


def quarantine_lanes(state, lanes, cfg: WholeRunConfig, scrub: bool):
    """One repair rung of the divergence-quarantine ladder, applied to
    faulted lanes: reset the lanes' hyperparameter carry to the cold init
    and clear ``seeded`` so their next body iteration performs a fresh
    cold fit; with ``scrub=True`` also drop non-finite observations from
    their GP datasets (``gp.scrub_dataset``). The lanes reactivate with
    ``fault`` cleared and their early-stop counter reset; ledger,
    incumbent and generation are untouched."""
    idx = _lane_index(lanes, state["n"])
    k = idx.shape[0]
    th0 = smod.resolve(cfg.surrogate, cfg.gp).init_theta((k,),
                                                         idx.device)
    state = dict(state)
    state["theta"] = {key: _set_rows(v, idx, th0[key])
                      for key, v in state["theta"].items()}
    if scrub:
        data = gpm.scrub_dataset(
            dict(x=state["x"][idx], y=state["y"][idx],
                 mask=state["mask"][idx]))
        for key in ("x", "y", "mask"):
            state[key] = _set_rows(state[key], idx, data[key])
    ones = torch.ones((k,), dtype=torch.bool, device=idx.device)
    state["seeded"] = _set_rows(state["seeded"], idx, ~ones)
    state["fault"] = _set_rows(state["fault"], idx, ~ones)
    state["active"] = _set_rows(state["active"], idx, ones)
    state["n_c"] = _set_rows(state["n_c"], idx, torch.zeros_like(idx))
    return state


# -- host-side input staging (shared by the offline and streaming engines) ---

def stage_scenario(sc: Scenario, l_pad: int, n_init: int,
                   constraint_aware: bool, fill: np.ndarray,
                   bank: Optional[PriorBank] = None, device="cuda") -> dict:
    """Host staging of ONE scenario into the padded-lane layout: device
    constraint params on ``device`` (at the scenario's own ``L`` —
    :func:`torch_cost.stack_params` pads to the batch ``l_pad``), the
    seeded init design, and the boundary candidate block padded to
    ``l_pad`` rows with ``fill``. The single staging path for offline
    batches and streaming admissions.

    With a prior ``bank`` the staging also queries the transfer-learned
    store: on a hit the staged dict carries the banked (theta,
    mean-prior) payload and — with incumbent seeding on — the FIRST
    init-design point is replaced by the historical incumbent (projected
    feasible for this scenario's channel). A miss (or ``bank=None``)
    stages the historical layout with a zeroed prior payload."""
    pb = sc.problem
    if pb.L > l_pad:
        raise ValueError(f"scenario L={pb.L} exceeds the engine l_pad="
                         f"{l_pad}")
    rng = np.random.default_rng(sc.seed)
    pts = _init_grid(n_init, rng)
    if constraint_aware:
        pts = np.stack([pb.project_feasible(a) for a in pts])
    prior_row, seed_a = stage_prior(sc, bank)
    if seed_a is not None:
        if constraint_aware:
            seed_a = pb.project_feasible(seed_a)
        pts = pts.copy()
        pts[0] = np.clip(seed_a, 0.0, 1.0)
    bpad = np.repeat(fill, l_pad, axis=0)
    if constraint_aware:
        b = pb.boundary_candidates()
        if len(b):
            bpad = bpad.copy()
            bpad[:len(b)] = b[:pb.L]
    return dict(params=pb.device_params(device=device), budget=sc.budget,
                init_pts=pts, boundary=bpad, **prior_row)


def stack_staged(staged: Sequence[dict], l_pad: int, pad_to: int) -> dict:
    """Stack per-scenario staging dicts (:func:`stage_scenario`) into the
    stacked lane inputs, on the staged params' device, repeating row 0
    out to ``pad_to`` lanes (padding rows are deactivated by the
    callers)."""
    staged = list(staged) + [staged[0]] * (pad_to - len(staged))
    dev = staged[0]["params"]["p_min"].device

    def lanes(values, dtype):
        # float64 host values round to float32, as jnp.asarray does
        return torch.as_tensor(np.asarray(values)).to(dev, dtype)

    return dict(
        params=tc.stack_params([st["params"] for st in staged],
                               l_pad=l_pad),
        budget=lanes([st["budget"] for st in staged], I32),
        init_pts=lanes(np.stack([st["init_pts"] for st in staged]), F32),
        boundary=lanes(np.stack([st["boundary"] for st in staged]), F32),
        # prior-bank payload (zeros on miss / bank=None)
        prior_mu=lanes([st["prior_mu"] for st in staged], F32),
        prior_n0=lanes([st["prior_n0"] for st in staged], F32),
        bank_hit=lanes([st["bank_hit"] for st in staged], torch.bool),
        theta0={k: lanes([st["theta0"][k] for st in staged], F32)
                for k in gpm.THETA_KEYS},
    )


def acq_wvec(w: AcqWeights, device="cuda") -> dict:
    """Acquisition weights as float32 scalars on ``device`` (shared by
    the offline engine and the streaming server)."""
    return {k: torch.tensor(getattr(w, k), dtype=F32, device=device)
            for k in ("lam_base0", "lam_baseT", "lam_g0", "lam_gT",
                      "lam_p", "beta")}


def result_from_row(out: dict, i: int, sc: Scenario) -> BOResult:
    """Build one scenario's ``BOResult`` from row ``i`` of an
    ``_OUT_KEYS`` snapshot (host numpy) — shared by the offline result
    unpacking and the streaming per-lane retirement flush."""
    n = int(out["n"][i])
    has_best = bool(out["has_best"][i])
    best_a = (np.asarray(out["best_a"][i], np.float64) if has_best
              else None)
    best_acc = 0.0
    if has_best:
        best_acc = float(sc.problem._accuracy(
            *sc.problem.denormalize(best_a))[1])
    return BOResult(
        best_a, float(out["best_u"][i]), best_acc, n,
        [float(v) for v in out["ev_u"][i][:n]],
        [float(v) for v in out["ev_acc"][i][:n]],
        [bool(v) for v in out["ev_feas"][i][:n]],
        [float(v) for v in out["ev_trace"][i][:n]])


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return _host(tree)


# -- host wrapper ------------------------------------------------------------

class WholeRunBayesSplitEdge:
    """Bayes-Split-Edge over a scenario batch with Algorithm 1's
    bookkeeping on ``device``.

    Same surface as ``BatchedBayesSplitEdge`` (one ``BOResult`` per
    scenario, trace-equivalent to sequential ``BayesSplitEdge.run`` up to
    float32 numerics), plus:

    * ``warm_start`` — warm-started adaptive GP refits (default on;
      ``False`` keeps the cold fits).
    * ``compact`` — between-phase lane compaction (default on): the run
      becomes a short sequence of phases, each sized to the next
      power of two over the surviving lanes. A pure re-scheduling of the
      same per-lane programs (``compact=False`` runs one loop over all
      lanes).
    * ``pack`` — architecture-aware lane packing: lanes sort by
      ``(n_layers, budget)`` so lanes that die together live together.
      Internal staging only: ``self.scenarios``, the returned results
      and the raw ledger stay aligned with the caller's order.
    * ``bank`` — a :class:`PriorBank` queried at staging and recorded
      into at run exit (None keeps every run on the historical path).
    """

    name = "WholeRun-Bayes-Split-Edge"

    def __init__(self, scenarios: Sequence[Scenario],
                 config: Optional[EngineConfig] = None, *,
                 bank: Optional[PriorBank] = None, device="cuda", **kw):
        config = resolve_config(config, kw, "WholeRunBayesSplitEdge")
        if kw:
            raise TypeError(f"WholeRunBayesSplitEdge() got unexpected "
                            f"keyword arguments {sorted(kw)}")
        if not scenarios:
            raise ValueError("need at least one scenario")
        self.device = resolve_device(device)
        scenarios = list(scenarios)
        self._pack_order = None
        self._staged = scenarios
        if config.pack:
            from repro_torch.distributed.sharding import pack_order
            self._pack_order = pack_order(scenarios)
            self._staged = [scenarios[i] for i in self._pack_order]
        # mixed-architecture batches pad every per-layer surface to the
        # batch-wide L_max (a single-arch batch pads to its own L)
        l_max = max(sc.problem.L for sc in scenarios)
        self.l_pad = l_max if config.l_pad is None else config.l_pad
        if self.l_pad < l_max:
            raise ValueError(f"l_pad={config.l_pad} < batch "
                             f"L_max={l_max}")
        self.config = config
        self.scenarios = scenarios
        self.n_init = config.n_init
        self.n_max_repeat = config.n_max_repeat
        self.weights = config.acq_weights()
        self.gp_cfg = config.gp_cfg
        self.grid = candidate_grid(config.grid_n)
        self.constraint_aware = config.constraint_aware
        self.use_schedules = config.use_schedules
        self.warm_start = config.warm_start
        self.surrogate = config.surrogate
        self.compact = config.compact
        self.gp_feasible_only = config.constraint_aware
        self.bank = bank

    # -- input staging -------------------------------------------------------
    def _pad_to(self) -> int:
        """Scenario count padded to a power of 2 (the reference's lane
        layout, which fixes the compaction's lane counts)."""
        return _next_pow2(len(self.scenarios))

    def _stacked(self) -> dict:
        staged = [stage_scenario(sc, self.l_pad, self.n_init,
                                 self.constraint_aware, self.grid[:1],
                                 bank=self.bank, device=self.device)
                  for sc in self._staged]
        return stack_staged(staged, self.l_pad, self._pad_to())

    # -- compaction loop -----------------------------------------------------
    def _run_compacted(self, stacked, grid, wvec, cfg: WholeRunConfig):
        """Phase sequence with between-phase lane compaction.

        After every phase the loop reads back the (tiny)
        ``active``/``n_pts`` vectors, gathers surviving lanes into a
        dense prefix at the next power-of-2 lane count (a device
        permutation of the whole state + lane-aligned inputs), and
        snapshots retiring lanes' outputs into their original scenario
        rows — the inverse scatter that makes the whole thing a pure
        permutation of the uncompacted run's results.
        """
        n_real = len(self.scenarios)
        s0 = stacked["budget"].shape[0]
        state, pen = init_run(stacked, grid, cfg)
        run_data = dict(params=stacked["params"],
                        boundary=stacked["boundary"],
                        budget=stacked["budget"], pen=pen)
        if s0 > n_real:
            # power-of-2 padding lanes duplicate scenario 0 and never
            # contribute results — deactivate them so the first
            # compaction drops them instead of stepping them
            state = dict(state, active=state["active"] & (
                torch.arange(s0, device=self.device) < n_real))
        order = np.arange(s0)       # lane row -> original scenario index
        order[n_real:] = -1
        final: dict = {}

        def flush(st, rows):
            """Inverse scatter for retiring lanes: gather just the given
            rows to the host and write them into their original scenario
            slots (lanes still running are flushed once, at exit). The
            final warm-start carry rides along for the prior bank."""
            rows = [r for r in rows if order[r] >= 0]
            if not rows:
                return
            idx = torch.as_tensor(np.asarray(rows), device=self.device)
            sub = {k: _host(st[k][idx]) for k in _OUT_KEYS}
            for tk in gpm.THETA_KEYS:
                sub["theta/" + tk] = _host(st["theta"][tk][idx])
            for k, v in sub.items():
                if k not in final:
                    final[k] = np.zeros((n_real,) + v.shape[1:], v.dtype)
            for j, r in enumerate(rows):
                for k in final:
                    final[k][order[r]] = sub[k][j]

        m_final = _final_bucket(cfg)
        it = 0
        lane_log: list = []
        while True:
            vals = _host(torch.stack([state["active"].to(I32),
                                      state["n_pts"]]))
            active, n_pts = vals[0].astype(bool), vals[1]
            live = np.flatnonzero(active)
            if live.size == 0:
                break
            m = gpm.bucket_size(int(n_pts[live].max()), cfg.gp.max_points)
            s_next = _next_pow2(live.size)
            if s_next < active.shape[0]:
                # retire exactly the lanes about to drop
                flush(state, np.setdiff1d(np.arange(active.shape[0]), live))
                state, run_data, keep = gather_live_lanes(
                    state, run_data, live, s_next)
                order = np.where(np.arange(s_next) < live.size,
                                 order[keep], -1)
            it_before = it
            state, it = run_phase(run_data, state, it, grid, wvec, cfg,
                                  m, m >= m_final)
            lane_log.append(dict(lanes=int(run_data["budget"].shape[0]),
                                 live=int(live.size), bucket=m,
                                 iters=it - it_before))
        flush(state, np.arange(state["n"].shape[0]))
        slots = sum(log["lanes"] * log["iters"] for log in lane_log)
        self._lane_stats = dict(
            n_dispatches=len(lane_log), lane_slots=slots,
            lane_log=lane_log)
        final["theta"] = {tk: final.pop("theta/" + tk)
                          for tk in gpm.THETA_KEYS}
        return final

    @torch.no_grad()
    def run(self) -> List[BOResult]:
        cfg = WholeRunConfig(
            n_init=self.n_init, n_max_repeat=self.n_max_repeat,
            # the ledger must hold the full init design even when a
            # scenario's budget is below n_init (the host engines still
            # evaluate all n_init points before stopping)
            budget_max=max(max(sc.budget for sc in self.scenarios),
                           self.n_init),
            l_pad=self.l_pad,
            constraint_aware=self.constraint_aware,
            gp_feasible_only=self.gp_feasible_only,
            use_schedules=self.use_schedules, warm_start=self.warm_start,
            gp=self.gp_cfg, surrogate=self.surrogate,
            use_prior=self.bank is not None)
        counts0 = dict(_counts)
        wvec = acq_wvec(self.weights, self.device)
        stacked = self._stacked()
        grid = torch.as_tensor(self.grid).to(self.device, F32)
        self._lane_stats = {}
        if self.compact:
            out = self._run_compacted(stacked, grid, wvec, cfg)
        else:
            out, n_iters = whole_run(stacked, grid, wvec, cfg)
            out = _to_host(out)
            self._lane_stats = dict(
                n_dispatches=1,
                lane_slots=n_iters * stacked["budget"].shape[0],
                lane_log=[dict(lanes=stacked["budget"].shape[0],
                               live=len(self.scenarios), iters=n_iters)])
        # raw device ledger (incl. per-eval split layers) — lets tests
        # audit that padded tail splits never entered the ledger. Row i
        # aligns with self.scenarios[i] (the caller's order)
        if self._pack_order is not None:
            rowmap = np.empty(len(self._pack_order), np.int64)
            rowmap[self._pack_order] = np.arange(len(self._pack_order))
            self._last_raw = gpm.take_lanes(out, rowmap)
        else:
            self._last_raw = out
        # fold retired runs into the transfer bank (frozen banks, runs
        # without a feasible incumbent and non-finite fits are skipped
        # inside record_result). Rows align with self._staged
        if self.bank is not None:
            th = out["theta"]
            for i in range(len(self._staged)):
                n = int(out["n"][i])
                self.bank.record_result(
                    self._staged[i],
                    (th["log_ls"][i], th["log_sv"][i], th["log_nv"][i]),
                    out["ev_u"][i][:n], out["ev_feas"][i][:n],
                    out["best_a"][i], out["best_u"][i],
                    bool(out["has_best"][i]))

        live = len(self.scenarios)
        evals = int(np.sum(out["n"][:live])) - live * self.n_init
        slots = self._lane_stats["lane_slots"]
        self._lane_stats["loop_evals"] = evals
        self._lane_stats["occupancy_mean"] = evals / slots if slots else 1.0
        self._lane_stats.update({k: v - counts0[k]
                                 for k, v in _counts.items()})
        fc = out["fit_calls"][:live].astype(np.int64)
        fs = out["fit_steps"][:live].astype(np.int64)
        calls, total = int(fc.sum()), int(fs.sum())
        # a lane's first counted refit (iteration 0, if it was active) is
        # the cold seed (cfg.fit_steps Adam steps); the warm-only mean is
        # the per-refit cost after it. Lanes that never fit (e.g.
        # budget == n_init) contribute nothing to either bucket.
        seeded = (fc > 0).astype(np.int64)
        if self.warm_start:
            warm_calls = int((fc - seeded).sum())
            warm_total = int((fs - seeded * self.gp_cfg.fit_steps).sum())
        else:
            warm_calls, warm_total = calls, total
        self._fit_stats = dict(
            fit_calls=calls,
            fit_steps_mean=float(total / calls) if calls else 0.0,
            warm_steps_mean=(float(warm_total / warm_calls)
                             if warm_calls else 0.0))

        results = [result_from_row(out, i, sc)
                   for i, sc in enumerate(self._staged)]
        if self._pack_order is not None:
            from repro_torch.distributed.sharding import unpack_results
            results = unpack_results(results, self._pack_order)
        return results

    def fit_cost_stats(self) -> dict:
        """Adam-step accounting of the last ``run``: total refit calls and
        mean Adam steps per refit (cold fits count ``fit_steps`` each)."""
        return dict(getattr(self, "_fit_stats", {}))

    def lane_stats(self) -> dict:
        """Lane-occupancy accounting of the last ``run``: computed
        lane-slots vs live-lane evals in the BO loop
        (``occupancy_mean == 1.0`` means no dead-lane waste), the
        per-phase lane log of the compaction loop, the iterations that
        ran the fit + acquisition (``acq_iters``) and the loop's
        device-to-host reads (``host_reads``; the warm fit's own reads,
        one an Adam step, are not among them)."""
        return dict(getattr(self, "_lane_stats", {}))
