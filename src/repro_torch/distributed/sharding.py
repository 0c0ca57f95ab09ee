"""Scenario-level packing for the BO engines: the scenario half of
``repro/distributed/sharding.py`` that ``batch_bo`` needs (``pack_order``,
``pack_scenarios``, ``unpack_results``). The mesh half (logical-axis
rules, ``ShardCtx``) belongs to the model layer and is not ported yet.
"""
from __future__ import annotations

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
