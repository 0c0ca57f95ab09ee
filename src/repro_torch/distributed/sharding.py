"""Scenario-level packing for the BO engines and admission placement for
the streaming server: the scenario half of ``repro/distributed/sharding.py``
(``pack_order``, ``pack_scenarios``, ``unpack_results``) and its admission
half (``ADMISSION_POLICIES``, ``admission_order``, ``next_admission_shard``,
``route_admission_shard``), host numpy. The mesh half (logical-axis rules,
``ShardCtx``) belongs to the model layer and is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def pack_order(scenarios):
    """Architecture-aware lane-packing permutation: a stable sort of the
    scenario batch by ``(n_layers, budget)``.

    Contiguous like-``L`` blocks mean a shard (or a packed sub-batch run
    as its own program) pads toward its *local* ``L_max`` instead of the
    global one, and contiguous like-budget blocks put lanes that exhaust
    their budgets together on the same shard / in the same compaction
    neighborhood — a shard of early finishers retires its device early,
    and the whole-run compaction driver drops whole waves at once.

    Returns ``order`` with ``order[j]`` = the input index of the j-th
    packed lane. A pure permutation: engines built with ``pack=True``
    invert it on their results, so packing is result-invariant.
    """
    keys = [(sc.problem.L, sc.budget) for sc in scenarios]
    return np.asarray(sorted(range(len(scenarios)), key=keys.__getitem__),
                      dtype=np.int64)


def pack_scenarios(scenarios, n_shards: int = 1):
    """Sort scenarios by ``(n_layers, budget)`` and split them into
    ``n_shards`` contiguous shards (sizes as equal as ``array_split``).

    Returns ``(shards, order)``; concatenating the shards yields the
    packed sequence and ``order`` is :func:`pack_order`'s permutation.
    Each shard's engine then pads to the shard-local ``L_max`` /
    ``budget_max`` on its own (``batch_bo.run_packed_shards``).
    """
    order = pack_order(scenarios)
    packed = [scenarios[i] for i in order]
    chunks = np.array_split(np.arange(len(packed)), max(1, n_shards))
    return [[packed[i] for i in ch] for ch in chunks], order


def unpack_results(results, order):
    """Invert a packing permutation: ``results[j]`` belongs to input
    index ``order[j]``; returns the list in input order. The single
    scatter shared by every pack consumer, so the pack_order contract
    lives in one place."""
    out = [None] * len(results)
    for j, i in enumerate(order):
        out[i] = results[j]
    return out


ADMISSION_POLICIES = ("fifo", "edf")


def admission_order(pending, now_s: float = 0.0, policy: str = "fifo"):
    """Admission-queue ordering policy for the streaming engine: given
    the pending queue as ``(arrival_index, Scenario)`` pairs, return the
    indices *into pending* in the order requests should claim freed
    lanes.

    * ``"fifo"`` — arrival order (the historical behavior);
    * ``"edf"`` — earliest-deadline-first: ascending slack
      (``deadline_s - now_s``); requests without a deadline sort last,
      ties (and the deadline-free tail) stay in arrival order, so a
      deadline-free feed under EDF is bitwise the FIFO schedule.

    A callable ``policy(pending, now_s) -> order`` plugs in custom
    scheduling (budget-aware slack, priorities) without touching the
    engine; this hook and :func:`next_admission_shard` together define
    where a request goes and when."""
    if callable(policy):
        return policy(pending, now_s)
    if policy == "fifo":
        return list(range(len(pending)))
    if policy == "edf":
        def slack(j):
            d = pending[j][1].deadline_s
            return float("inf") if d is None else d - now_s
        return sorted(range(len(pending)), key=lambda j: (slack(j), j))
    raise ValueError(f"unknown admission policy {policy!r} "
                     f"(one of {ADMISSION_POLICIES} or a callable)")


def next_admission_shard(free_lanes, rr: int = 0):
    """Admission placement for the streaming engine's per-shard lane
    pools (``repro_torch.runtime.stream``): pick the shard with the most free
    lanes, ties broken round-robin starting from ``rr``. Returns the
    shard index, or ``None`` when no shard has a free lane.

    Per-shard admission is what keeps the multi-pool/mesh streaming
    path collective-free: a request is bound to exactly one shard's
    lane pool at admission, each pool dispatches its own whole-run
    phase programs independently (the established zero-collective
    scenario-sharding argument), and results gather host-side — no
    cross-shard rebalancing of a live lane ever happens.
    """
    n = len(free_lanes)
    best, best_free = None, 0
    for j in range(n):
        i = (rr + j) % n
        if free_lanes[i] > best_free:
            best, best_free = i, free_lanes[i]
    return best


# routing score deadband: a pool's EWMA dispatch wall must exceed the
# fleet median by more than this fraction before it costs the pool any
# admission score. Healthy pools run identical-shape programs, so their
# walls sit within timing noise of each other — the deadband keeps the
# score integer-valued (== free lanes) on a healthy fleet, which makes
# placement deterministic across identical runs and reduces the router
# exactly to most-free/round-robin when every pool is healthy.
ROUTE_WALL_DEADBAND = 0.5


def route_admission_shard(features, rr: int = 0,
                          wall_deadband: float = ROUTE_WALL_DEADBAND,
                          wall_ref: Optional[float] = None):
    """Load- and health-aware admission placement — the failover
    generalization of :func:`next_admission_shard`. ``features`` is one
    dict per pool:

    * ``free`` — free lanes (0 for dead pools);
    * ``ewma_wall_s`` — EWMA per-dispatch wall clock (None until the
      pool's first flush);
    * ``stale_frac`` — heartbeat staleness as a fraction of the grace
      window (0 while the pool is reporting; grows for muted/hung
      pools);
    * ``backoff`` — True while the pool sits in its failover
      exponential-backoff window (or is dead/muted): it takes no new
      admissions.

    Score: ``free / ((1 + wall_excess) * (1 + stale_frac))`` where
    ``wall_excess`` is the pool's EWMA dispatch wall over the fleet
    median, less the deadband — free capacity discounted by how slow
    and how silent the pool is. The best score wins; ties (every
    healthy fleet: scores are then the integer free-lane counts) break
    round-robin from ``rr``, so on a healthy fleet this routes
    identically to :func:`next_admission_shard`. Returns ``None`` when
    no eligible pool has a free lane — with every pool in backoff the
    queue simply waits a round (backoff windows are capped by the
    engine's drop-pool escalation, so this cannot deadlock).

    ``wall_ref`` overrides the wall-excess reference (the caller's
    fleet-wide median); without it the median of the walls present in
    ``features`` is used."""
    n = len(features)
    if wall_ref is not None:
        med = float(wall_ref)
    else:
        walls = [f.get("ewma_wall_s") for f in features
                 if not f.get("backoff") and f.get("ewma_wall_s")]
        med = float(np.median(walls)) if walls else 0.0
    best, best_score = None, 0.0
    for j in range(n):
        i = (rr + j) % n
        f = features[i]
        free = int(f.get("free", 0))
        if free <= 0 or f.get("backoff"):
            continue
        excess = 0.0
        w = f.get("ewma_wall_s")
        if w and med > 0.0:
            excess = max(0.0, w / med - 1.0 - wall_deadband)
        stale = max(0.0, float(f.get("stale_frac") or 0.0))
        score = free / ((1.0 + excess) * (1.0 + stale))
        if score > best_score:
            best, best_score = i, score
    return best
