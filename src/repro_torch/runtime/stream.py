"""Streaming scenario ingestion: an admission-queue serving engine over
the whole-run engine's padded lanes. Counterpart of
``repro/runtime/stream.py``.

The offline engines consume a static scenario list; production serving
is a *stream* of (channel state, budget, architecture) requests. The
whole-run engine's compaction frees lanes mid-run — exactly the slots an
admission queue needs — so this engine turns the whole-run state machine
from run-to-completion into a long-lived server loop:

* a fixed pool of padded lanes (power-of-2 ``n_lanes``, padded to the
  engine-wide ``l_pad`` / ``budget_max`` so every lane of every
  dispatch has the same shapes for the life of the server);
* ``wholerun.stream_phase`` steps the pool until ANY lane retires (the
  lane-free event — ``run_phase``'s half-capacity compaction exit,
  sharpened to per-lane granularity) or a live dataset outgrows its
  bucket;
* retiring lanes are flushed to per-request results immediately (the
  completion queue/callback), and freed lanes are re-initialized IN
  PLACE with the next queued requests via ``wholerun.admit_lanes`` —
  the compaction gather run in reverse as an *admission scatter*: a
  freshly staged mini-batch (the same ``wholerun.stage_scenario`` path
  the offline engines use, at the batch ``l_pad``) is written into the
  freed rows of the full state dict;
* per-lane ``seeded`` flags make a late admit cold-seed its GP carry on
  its own first iteration (the per-lane generalization of the offline
  iteration-0 seed), and per-lane ``gen`` counters make ledger
  snapshots attributable to exactly one occupant — a re-admitted lane
  never inherits its predecessor's rows.

Every lane's trajectory is a function of its own state only: the fit
and the acquisition run on chunks of exactly ``wholerun.LANE_WIDTH``
lanes whatever the pool width (a narrower pool computes one padded
chunk, a wider one a chunk per 16 lanes), so streaming is a pure
re-scheduling: a replayed arrival trace yields results bitwise equal
(cold fits) / within the studied warm tolerance to running the same
scenarios as one offline batch, in ANY admission order
(``tests/test_torch_stream.py``, ``chip_smoke.py`` phase 4c).

The loop is host-driven eager torch on ``device`` (the card unless the
caller asks for the CPU): every device-to-host read of the serving loop
goes through ``wholerun._host``/``wholerun._read`` and is counted in
``stream_stats()["host_reads"]``; a collect fetches all its retired
rows in one read.

Sharding: ``n_shards`` splits the pool into independent per-shard lane
pools (optionally pinned to distinct torch devices with ``devices=``;
on one card every shard shares it). Admission binds each request to one
shard (``sharding.next_admission_shard``), each shard dispatches its own
phases, and results gather host-side — zero collectives by construction.

Failure model (exercised by ``runtime.chaos.FaultInjector``):

* **Crash safety** — ``ckpt_dir``/``ckpt_every`` snapshot the full
  serving state (pool state dicts, host lane maps, the admission queue
  and the emitted-result watermark) at the top of every k-th round via
  ``checkpoint/ckpt.py``'s atomic commits, in the reference's keys and
  dtypes (a snapshot loads in either package); ``resume()`` rebuilds the
  server from the latest commit and replays the feed's consumed prefix.
  Emission is *at-least-once*: results emitted after the last snapshot
  re-emit after resume — :func:`dedup_results` (first result per
  arrival index wins) restores exactly-once, and the post-dedup stream
  replay-matches the uninterrupted run.
* **Divergence quarantine** — a lane whose GP fit goes non-finite
  freezes with the per-lane ``fault`` flag instead of poisoning the
  batch; the host escalates per request: re-admit as a fresh run
  (``quarantine="requeue"``, bounded by ``max_requeues``, replay-clean
  because the re-run is an ordinary cold run), then in-place repair
  rungs (re-seed the carry, scrub the dataset —
  ``wholerun.quarantine_lanes``), then degraded retirement with the
  best-effort feasible-projection answer (``wholerun.retire_lanes``).
* **Deadlines** — requests may carry an absolute ``deadline_s`` (trace
  time); ``admission_policy="edf"`` orders the queue by slack, and
  ``shed_hopeless=True`` preempts in-flight lanes that cannot finish in
  time (EWMA-estimated remaining work) and sheds hopeless queued
  requests immediately — both emit a ``degraded=True`` result rather
  than silently rejecting, so every admitted request emits exactly one
  result (the no-wedge invariant).
* **Pool loss** — a dead pool (chaos drop, or ``HeartbeatMonitor``
  timeout with ``heartbeat_timeout_s``) re-enqueues its in-flight
  requests onto surviving pools; re-execution is bounded (one re-run
  per drop event) and the server raises only when every pool is lost.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckptlib
from repro_torch.core import gp as gpm
from repro_torch.core import wholerun as wr
from repro_torch.core.acquisition import candidate_grid
from repro_torch.core.batch_bo import Scenario, scenario_from_request
from repro_torch.core.bo import BOResult
from repro_torch.core.engine_config import EngineConfig, resolve_config
from repro_torch.core.priorbank import PriorBank
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.distributed.sharding import (ADMISSION_POLICIES,
                                              admission_order,
                                              next_admission_shard,
                                              route_admission_shard)

# vocabulary of degraded-result reasons (checkpointed as codes — the
# tuple is APPEND-ONLY: existing checkpoints store indices into it;
# "undeliverable" is the fleet router's retry-budget-exhausted verdict)
DEGRADED_REASONS = ("quarantine", "preempted", "shed", "rejected",
                    "undeliverable")

QUARANTINE_POLICIES = ("requeue", "repair")

# what to do with a new arrival once the admission queue holds
# ``max_pending`` requests:
# * "block"      — stop pulling the feed (backpressure: timed arrivals
#   wait in the feed; order-driven feeds simply aren't consumed);
# * "reject"     — accept-and-refuse: the arrival emits a degraded
#   result (reason "rejected") immediately, never taking queue space;
# * "shed-oldest"— evict the oldest hopeless queued request (falling
#   back to the oldest outright) with a degraded "shed" result, then
#   queue the new arrival — composes with EDF + shed_hopeless: the
#   eviction prefers requests the deadline triage would shed anyway.
OVERLOAD_POLICIES = ("block", "reject", "shed-oldest")

ROUTING_POLICIES = ("score", "rr")


@dataclasses.dataclass
class StreamResult:
    """One converged request, emitted in completion order."""
    index: int                 # arrival index in the feed
    scenario: Scenario
    result: BOResult
    pool: int                  # shard/pool the run was served on
    lane: int                  # lane it finished in
    gen: int                   # that lane's generation while it ran
    raw: dict                  # audit-ledger row snapshot (_OUT_KEYS)
    degraded: bool = False     # best-effort answer (shed/preempt/quarantine)
    reason: str = ""           # one of DEGRADED_REASONS when degraded
    emit_s: float = 0.0        # emission time (trace seconds)


def requests_from_trace(trace: dict) -> List[Scenario]:
    """Decode an arrival trace (``wireless.traces.arrival_trace``) into
    the Scenario feed, one per arrival, in arrival order. Traces with a
    ``deadline_s`` column yield deadline-carrying scenarios. The arch
    column covers the whole request registry
    (``core.batch_bo.request_archs()``) — CNN and LM-decoder arrivals
    decode into one mixed feed, padded to the serving ``l_pad``."""
    deadlines = trace.get("deadline_s") or [None] * len(trace["arch"])
    return [scenario_from_request(arch, off, budget, seed, deadline_s=d)
            for arch, off, budget, seed, d in zip(
                trace["arch"], trace["gain_offset_db"], trace["budget"],
                trace["init_seed"], deadlines)]


def dedup_results(results: Iterable[StreamResult]) -> List[StreamResult]:
    """At-least-once -> exactly-once: keep the first result per arrival
    index, in the order seen. A crashed-and-resumed serve re-emits
    whatever landed between the last snapshot and the crash; after this
    dedup the stream is the uninterrupted run's (gen/lane placement may
    differ — the result payloads are what replay-matches)."""
    seen = set()
    out = []
    for r in results:
        if r.index not in seen:
            seen.add(r.index)
            out.append(r)
    return out


def host_degraded_result(idx: int, sc: Scenario, now_trace: float,
                         reason: str) -> StreamResult:
    """Degraded answer produced host-side, no lane ever consumed: the
    feasible projection of the search-space center. Module-level so
    both the streaming engine (shed/reject/preempt bookkeeping in
    ``_host_result``) and the fleet router (``runtime/fleet.py``
    oversized rejection and retry-budget exhaustion) emit the identical
    payload for the same request."""
    a = sc.problem.project_feasible(np.array([0.5, 0.5]))
    feas = sc.problem.feasible(a)
    u = float(sc.problem.evaluate(a, record=False))
    acc = float(sc.problem._accuracy(*sc.problem.denormalize(a))[1])
    res = BOResult(
        np.asarray(a, np.float64) if feas else None,
        u if feas else -np.inf, acc if feas else 0.0,
        0, [], [], [], [])
    return StreamResult(index=idx, scenario=sc, result=res,
                        pool=-1, lane=-1, gen=-1, raw={},
                        degraded=True, reason=reason,
                        emit_s=now_trace)


def _to(tree, device):
    """``tree`` (nested dicts of tensors) with every tensor on ``device``."""
    return ckptlib._map_leaves(
        lambda _, v: v.to(device) if isinstance(v, torch.Tensor) else v,
        tree)


def _fetch_rows(tensors: dict, idx: torch.Tensor) -> dict:
    """Rows ``idx`` of every tensor in ``tensors`` (name -> lane-major
    tensor) as host numpy arrays of the same dtypes, in ONE
    device-to-host read: each row block is viewed as bytes, the blocks
    are joined, read once and viewed back, so the values are exact."""
    k = idx.shape[0]
    parts, layout = [], []
    for name, t in tensors.items():
        r = t[idx].contiguous()
        b = r.reshape(k, -1).view(torch.uint8)
        parts.append(b)
        layout.append((name, b.shape[1], r.shape,
                       torch.empty(0, dtype=r.dtype).numpy().dtype))
    host = wr._host(torch.cat(parts, dim=1))
    out, c0 = {}, 0
    for name, nb, shape, dt in layout:
        out[name] = np.ascontiguousarray(host[:, c0:c0 + nb]).view(
            dt).reshape(tuple(shape))
        c0 += nb
    return out


class _LanePool:
    """One shard's padded-lane pool: the device state dict plus the host
    lane map (lane -> request index, lane generation)."""

    def __init__(self, pool_id: int, width: int, engine,
                 device: torch.device):
        self.pool_id = pool_id
        self.width = width
        self.eng = engine
        self.device = device
        self.grid = engine.grid.to(device)
        self.wvec = _to(engine.wvec, device)
        self.state = None          # no lanes admitted yet
        self.run_data = None
        self.it = 0                # loop iterations over the pool's life
        self.it_host = 0           # ... at the last collect
        self.order = np.full(width, -1, np.int64)   # lane -> request idx
        self.gen = np.zeros(width, np.int64)        # host mirror of gen
        # stable lane identity: shrink gathers permute rows, but a
        # result's (pool, lane, gen) triple must keep naming the lane
        # the run actually occupied
        self.lane_ids = np.arange(width, dtype=np.int64)
        # next unissued lane id: elastic resizes mint fresh ids so a
        # (pool, lane, gen) triple never collides across pool widths
        self._lane_seq = width
        self.dead = False          # pool lost (chaos drop / heartbeat)
        self.muted = False         # heartbeat silenced (hung-host model)
        # failover-routing health signals
        self.ewma_wall = None      # EWMA per-dispatch wall clock (s)
        self.backoff_level = 0     # consecutive unhealthy strikes
        self.backoff_until = 0.0   # no admissions before this (serve s)
        # elastic-controller state (hysteresis over queue pressure)
        self.ewma_free = 0.0       # EWMA lanes freed per dispatch
        self.hot = 0               # consecutive under-capacity rounds
        self.cold = 0              # consecutive over-capacity rounds
        self.cool = 0              # post-resize cooldown countdown

    # -- admission -----------------------------------------------------------
    def free_count(self) -> int:
        if self.dead:
            return 0
        return int(np.sum(self.order < 0))

    def live_count(self) -> int:
        if self.state is None or self.dead:
            return 0
        return int(wr._read(self.state["active"].sum()))

    def admit(self, reqs: Sequence) -> None:
        """Admit (index, Scenario) pairs into freed lanes, in place.

        Staging is the offline engines' own path (``stage_scenario`` +
        ``stack_staged`` at the engine ``l_pad``), so an admitted lane
        is bitwise the lane an offline batch would have staged.
        """
        eng, k = self.eng, len(reqs)
        free = np.flatnonzero(self.order < 0)[:k]
        if len(free) != k:
            raise RuntimeError(f"admission of {k} requests exceeds the "
                               f"{len(free)} free lanes of pool "
                               f"{self.pool_id}")
        staged = [eng._stage_request(idx, sc) for idx, sc in reqs]
        # mini-batch sized to the admission (power of 2, capped by the
        # pool width) — late small admissions don't pay a full-width
        # init/seed; cold starts ARE the pool, so they stage at width.
        # The seed fits run on LANE_WIDTH chunks either way
        kpad = self.width if self.state is None else wr._next_pow2(k)
        stacked = _to(wr.stack_staged(staged, eng.l_pad, kpad), self.device)
        # warm path: cold-seed the admitted lanes' GP carries here, so
        # the serving body only ever pays warm refits
        new_state, pen = wr.admit_init(stacked, self.grid, eng.cfg,
                                       eng.cfg.warm_start)
        new_rd = dict(params=stacked["params"],
                      boundary=stacked["boundary"],
                      budget=stacked["budget"], pen=pen)
        if self.state is None:
            # pool cold start: the mini batch IS the pool
            if k < self.width:      # padding duplicates stay frozen
                new_state = dict(new_state, active=new_state["active"] & (
                    torch.arange(self.width, device=self.device) < k))
            self.state, self.run_data = new_state, new_rd
        else:
            self.state, self.run_data = wr.admit_lanes(
                self.state, self.run_data, new_state, new_rd, free)
            self.gen[free] += 1
        for lane, (idx, _) in zip(free, reqs):
            self.order[lane] = idx

    # -- serving -------------------------------------------------------------
    def dispatch(self, draining: bool = False) -> Optional[dict]:
        """One ``stream_phase`` over the pool; returns the lane log entry
        (lanes/live/bucket, the phase's acquisition iterations and the
        ``LANE_WIDTH`` chunks each computes) or None when nothing is
        live.

        With requests queued the phase exits on the FIRST retirement
        (the admission queue wants every freed lane immediately); once
        the queue is empty (``draining``) it falls back to the offline
        compaction exit — run until live lanes halve — so the tail of
        the stream doesn't pay a host round-trip per retirement."""
        eng = self.eng
        vals = wr._host(torch.stack([self.state["active"].to(torch.int32),
                                     self.state["n_pts"]]))
        active, n_pts = vals[0].astype(bool), vals[1]
        live = int(active.sum())
        if live == 0:
            return None
        m = gpm.bucket_size(int(n_pts[active].max()),
                            eng.cfg.gp.max_points)
        last = m >= wr._final_bucket(eng.cfg)
        live0 = (live // 2 + 1) if draining else live
        acq0 = wr._counts["acq_iters"]
        self.state, self.it = wr.stream_phase(
            self.run_data, self.state, self.it, live0, self.grid,
            self.wvec, eng.cfg, m, last)
        return dict(pool=self.pool_id, lanes=self.width, live=live,
                    bucket=m, acq_iters=wr._counts["acq_iters"] - acq0,
                    chunks=-(-self.width // wr.LANE_WIDTH))

    def collect(self) -> Tuple[List[StreamResult], List[int], int]:
        """Flush lanes that retired since the last collect — snapshot
        their ledger rows BEFORE any admission scatter reuses them, in
        one device-to-host read. Returns ``(results, faulted lane rows,
        loop iterations since the last collect)``; faulted lanes
        (non-finite fit — frozen by the body with ``fault`` set) are NOT
        flushed: the engine runs the quarantine ladder on them."""
        if self.state is None:
            return [], [], 0
        flags = wr._host(torch.stack([self.state["active"],
                                      self.state["fault"]]))
        active, fault = flags[0], flags[1]
        rows = [r for r in range(self.width)
                if self.order[r] >= 0 and not active[r] and not fault[r]]
        faulted = [r for r in range(self.width)
                   if self.order[r] >= 0 and fault[r]]
        out = []
        if rows:
            bank = self.eng.bank
            want = {k: self.state[k] for k in wr._OUT_KEYS}
            if bank is not None:
                want.update({"theta/" + k: self.state["theta"][k]
                             for k in ("log_ls", "log_sv", "log_nv")})
            sub = _fetch_rows(want, wr._lane_index(rows, self.state["n"]))
            for j, r in enumerate(rows):
                req_idx = int(self.order[r])
                # evict: a long-lived server must not accumulate every
                # request it ever served (StreamResult carries it on)
                sc = self.eng._requests.pop(req_idx)
                raw = {k: sub[k][j] for k in wr._OUT_KEYS}
                reason = self.eng._degraded.pop(req_idx, "")
                if bank is not None and not reason:
                    # fold the retired run into the transfer bank
                    # (degraded answers — preempted/shed/quarantined —
                    # must not teach the prior)
                    n = int(sub["n"][j])
                    bank.record_result(
                        sc, (sub["theta/log_ls"][j], sub["theta/log_sv"][j],
                             sub["theta/log_nv"][j]),
                        sub["ev_u"][j][:n], sub["ev_feas"][j][:n],
                        sub["best_a"][j], sub["best_u"][j],
                        bool(sub["has_best"][j]))
                out.append(StreamResult(
                    index=req_idx, scenario=sc,
                    result=wr.result_from_row(sub, j, sc),
                    pool=self.pool_id, lane=int(self.lane_ids[r]),
                    gen=int(self.gen[r]), raw=raw,
                    degraded=bool(reason), reason=reason))
                self.order[r] = -1
        iters, self.it_host = self.it - self.it_host, self.it
        return out, faulted, iters

    def repair(self, lanes: Sequence[int], scrub: bool) -> None:
        """In-place quarantine repair rung (re-seed; optionally scrub
        the GP dataset) — the same occupant continues."""
        self.state = wr.quarantine_lanes(self.state, lanes, self.eng.cfg,
                                         scrub)

    def retire(self, lanes: Sequence[int]) -> None:
        """Force-retire lanes with the best-effort degraded answer; the
        next collect flushes them as ordinary retirements."""
        self.state = wr.retire_lanes(self.state, self.run_data, lanes)

    def shrink(self) -> None:
        """Drain-mode compaction: once the feed is exhausted, gather the
        surviving lanes into the next power-of-2 pool (the offline
        between-phase gather, applied to a shrinking server)."""
        if self.state is None:     # shard never received an admission
            return
        active = wr._host(self.state["active"])
        live = np.flatnonzero(active)
        if live.size == 0 or 2 * live.size > self.width:
            return
        s_next = wr._next_pow2(live.size)
        self.state, self.run_data, keep = wr.gather_live_lanes(
            self.state, self.run_data, live, s_next)
        self.order = np.where(np.arange(s_next) < live.size,
                              self.order[keep], -1)
        self.gen = self.gen[keep]
        self.lane_ids = self.lane_ids[keep]
        self.width = s_next

    def resize_to(self, s_next: int) -> None:
        """Elastic resize between dispatches — grow or shrink: gather
        the occupied rows (active, faulted, or retired-but-unflushed —
        anything the host still owes an emission for) into a dense
        prefix of the new width (``wholerun.resize_lanes``, the
        compaction gather run in either direction), and bring the tail
        up as genuinely free lanes: fresh lane ids and zeroed
        generations, ready for an ordinary admission scatter. A pure
        re-scheduling — every occupant's per-lane state rides along
        unchanged — so elastic runs keep the replay contract by
        construction."""
        if s_next == self.width:
            return
        occ = np.flatnonzero(self.order >= 0)
        if occ.size > s_next:
            raise ValueError(f"cannot resize pool {self.pool_id} to "
                             f"{s_next}: {occ.size} lanes are occupied")
        if self.state is not None:
            self.state, self.run_data = wr.resize_lanes(
                self.state, self.run_data, occ, s_next)
        order = np.full(s_next, -1, np.int64)
        order[:occ.size] = self.order[occ]
        gen = np.zeros(s_next, np.int64)
        gen[:occ.size] = self.gen[occ]
        lane_ids = np.arange(self._lane_seq, self._lane_seq + s_next,
                             dtype=np.int64)
        lane_ids[:occ.size] = self.lane_ids[occ]
        self._lane_seq += s_next
        self.order, self.gen, self.lane_ids = order, gen, lane_ids
        self.width = s_next


class StreamingBayesSplitEdge:
    """Admission-queue Bayes-Split-Edge server over compacted lanes.

    ``requests`` is the arrival feed — any iterable of ``Scenario``
    (materialized lists replay a trace; generators are consumed lazily,
    one pull per freed lane). ``serve()`` yields a ``StreamResult`` per
    request as it converges (completion order); ``run()`` drains the
    feed and returns plain ``BOResult``s in arrival order — the
    offline-equivalence surface.

    Static server shapes (fixed for the life of the server, so every
    dispatch runs lanes of the same shapes):

    * ``n_lanes`` — total lane capacity (a power of 2), split evenly
      over ``n_shards`` independent pools;
    * ``l_pad`` — max supported layer count;
    * ``budget_max`` — max supported evaluation budget (ledger length).

    Requests exceeding either static shape are *rejected*, not raised:
    they emit one degraded ``StreamResult`` (reason ``"rejected"``,
    zero evaluations) so a live feed never kills the serve loop.

    Overload tolerance (the elastic-serving layer):

    * ``elastic`` + ``n_lanes_min``/``n_lanes_max`` — grow/shrink each
      pool between dispatches (power-of-2 widths, hysteresis over queue
      share and EWMA lane-free rate; see ``docs/engine.md``). Elastic
      runs replay-match a fixed-width run on the same feed.
    * ``max_pending`` + ``overload`` — bound the admission queue; the
      policy (``"block"``/``"reject"``/``"shed-oldest"``) decides what
      happens at the bound. Every accepted request still emits exactly
      one result.
    * ``routing`` — ``"score"`` (default) places admissions by free
      capacity discounted by pool health and drives the failover
      ladder (backoff -> rebalance -> drop) when a monitor is armed;
      ``"rr"`` is the historical most-free/round-robin placement.
      On a healthy fleet ``"score"`` reduces exactly to ``"rr"``.

    ``device`` is where the pools run: the card unless the caller asks
    for the CPU (``device="cpu"``); without CUDA the default raises.
    ``devices`` (torch devices) pins shard ``i`` to
    ``devices[i % len(devices)]`` instead.

    ``arrivals`` (optional, aligned with the feed, in seconds scaled by
    ``time_scale``) paces admission against the wall clock for
    queue-depth/soak studies; without it the feed is purely
    order-driven and fully deterministic.

    Fault tolerance (all off by default — a default-constructed server
    is bitwise the pre-fault-tolerance engine):

    * ``ckpt_dir`` + ``ckpt_every`` — snapshot the serving state every
      k-th round (atomic commits; ``ckpt_keep`` most recent retained);
      ``StreamingBayesSplitEdge.resume(ckpt_dir, requests)`` rebuilds
      the server from the latest commit. ``checkpoint_now()`` forces a
      snapshot (the SIGTERM drain hook).
    * ``quarantine`` — the divergence ladder: ``"requeue"`` re-admits a
      faulted request as a fresh run first (``max_requeues`` times),
      then the in-place repair rungs; ``"repair"`` goes straight to
      re-seed -> scrub -> degraded retirement.
    * ``admission_policy`` — ``"fifo"`` (default), ``"edf"``, or a
      callable (``sharding.admission_order``).
    * ``shed_hopeless`` — preempt in-flight lanes and shed queued
      requests whose deadlines are unmeetable (EWMA-estimated remaining
      work, scaled by ``shed_safety``), emitting degraded results.
    * ``chaos`` — a ``runtime.chaos.FaultInjector`` driven by the serve
      loop (tests/benchmarks only).
    * ``heartbeat_timeout_s`` — arm a ``HeartbeatMonitor`` over the
      pools; a pool silent for this long is declared dead and its
      in-flight requests re-enter the queue.
    """

    name = "Streaming-Bayes-Split-Edge"
    # per-dispatch stat traces (lane_log / queue_depth) keep at most
    # this many recent entries — a long-lived server's aggregate stats
    # accumulate in O(1) regardless of stream length
    STATS_TRACE_CAP = 4096
    # elastic hysteresis: consecutive under-/over-capacity rounds
    # before a pool grows/shrinks, and the post-resize cooldown — wide
    # apart on purpose so queue noise cannot make a pool thrash
    ELASTIC_GROW_PATIENCE = 2
    ELASTIC_SHRINK_PATIENCE = 4
    ELASTIC_COOLDOWN = 4
    # failover: a pool whose EWMA dispatch wall exceeds this multiple
    # of the other alive pools' median is a straggler (engine-side test
    # — the monitor's MAD rule cannot fire on a 2-pool fleet)
    ROUTE_STRAGGLER_X = 3.0

    def __init__(self, requests: Iterable[Scenario],
                 config: Optional[EngineConfig] = None, *,
                 n_lanes: int = 8, l_pad: Optional[int] = None,
                 budget_max: Optional[int] = None, n_shards: int = 1,
                 devices: Optional[Sequence] = None,
                 device="cuda",
                 arrivals: Optional[Sequence[float]] = None,
                 time_scale: float = 1.0,
                 on_result: Optional[Callable[[StreamResult], None]] = None,
                 bank: Optional[PriorBank] = None,
                 admission_policy="fifo",
                 shed_hopeless: bool = False, shed_safety: float = 1.0,
                 quarantine: str = "requeue", max_requeues: int = 1,
                 fault_on_divergence: bool = False,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: int = 3, chaos=None,
                 heartbeat_timeout_s: Optional[float] = None,
                 elastic: bool = False,
                 n_lanes_min: Optional[int] = None,
                 n_lanes_max: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 overload: str = "block",
                 routing: str = "score",
                 route_backoff_s: float = 0.05,
                 route_max_retries: int = 3, **kw):
        # BO-engine knobs (n_init, gp_cfg, warm_start, ...) arrive via
        # the shared EngineConfig; legacy keyword arguments fold over it
        # through the deprecation shim. l_pad is a *serving* static here
        # (the explicit parameter above), not the EngineConfig field.
        config = resolve_config(config, kw, "StreamingBayesSplitEdge")
        if kw:
            raise TypeError(f"StreamingBayesSplitEdge() got unexpected "
                            f"keyword arguments {sorted(kw)}")
        if n_lanes < 1 or n_shards < 1 or n_lanes % n_shards:
            raise ValueError("n_lanes must split evenly over n_shards")
        width = n_lanes // n_shards
        if wr._next_pow2(width) != width:
            raise ValueError(f"per-shard lane count {width} must be a "
                             f"power of 2")
        n_lanes_min = n_lanes if n_lanes_min is None else int(n_lanes_min)
        n_lanes_max = n_lanes if n_lanes_max is None else int(n_lanes_max)
        if elastic:
            for name, v in (("n_lanes_min", n_lanes_min),
                            ("n_lanes_max", n_lanes_max)):
                if v < n_shards or v % n_shards:
                    raise ValueError(f"{name}={v} must split evenly "
                                     f"over {n_shards} shards")
                w = v // n_shards
                if wr._next_pow2(w) != w:
                    raise ValueError(f"{name} per-shard width {w} must "
                                     f"be a power of 2")
            if not n_lanes_min <= n_lanes <= n_lanes_max:
                raise ValueError(
                    f"need n_lanes_min <= n_lanes <= n_lanes_max, got "
                    f"{n_lanes_min} / {n_lanes} / {n_lanes_max}")
        if max_pending is not None and int(max_pending) < 1:
            raise ValueError("max_pending must be at least 1")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(f"unknown overload policy {overload!r} "
                             f"(one of {OVERLOAD_POLICIES})")
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {routing!r} "
                             f"(one of {ROUTING_POLICIES})")
        if (not callable(admission_policy)
                and admission_policy not in ADMISSION_POLICIES):
            raise ValueError(f"unknown admission policy "
                             f"{admission_policy!r}")
        if quarantine not in QUARANTINE_POLICIES:
            raise ValueError(f"unknown quarantine policy {quarantine!r} "
                             f"(one of {QUARANTINE_POLICIES})")
        if ckpt_every and not ckpt_dir:
            raise ValueError("ckpt_every needs a ckpt_dir")
        if l_pad is None or budget_max is None:
            if not hasattr(requests, "__len__"):
                raise ValueError(
                    "an iterator feed needs explicit l_pad/budget_max "
                    "(the server's static shapes can't be derived from "
                    "requests that haven't arrived yet)")
            reqs = list(requests)
            if not reqs:
                l_pad = l_pad or 1
                budget_max = budget_max or 1
            else:
                l_pad = (max(sc.problem.L for sc in reqs)
                         if l_pad is None else l_pad)
                budget_max = (max(sc.budget for sc in reqs)
                              if budget_max is None else budget_max)
            requests = reqs
        self.device = resolve_device(device)
        self._feed = iter(requests)
        self._feed_len = (len(requests)
                          if hasattr(requests, "__len__") else None)
        self.n_lanes = n_lanes
        self.n_shards = n_shards
        self.l_pad = l_pad
        self.budget_max = budget_max
        self.devices = (None if devices is None
                        else [resolve_device(d) for d in devices])
        self.arrivals = (None if arrivals is None
                         else [float(t) for t in arrivals])
        self.time_scale = float(time_scale)
        self.on_result = on_result
        self.config = config
        self.n_init = config.n_init
        self.weights = config.acq_weights()
        self.wvec = wr.acq_wvec(self.weights, self.device)
        self.constraint_aware = config.constraint_aware
        self.grid_np = candidate_grid(config.grid_n)
        self.grid = torch.as_tensor(self.grid_np).to(self.device,
                                                     torch.float32)
        # transfer-learned prior bank: queried at request staging,
        # recorded into at lane retirement, checkpointed with the
        # serving state (None keeps every program bitwise-historical)
        self.bank = bank
        self.cfg = wr.WholeRunConfig(
            n_init=config.n_init, n_max_repeat=config.n_max_repeat,
            # like the offline engine: the ledger must hold the full
            # init design even for budgets below n_init
            budget_max=max(budget_max, config.n_init), l_pad=l_pad,
            constraint_aware=config.constraint_aware,
            gp_feasible_only=config.constraint_aware,
            use_schedules=config.use_schedules,
            warm_start=config.warm_start, gp=config.gp_cfg,
            fault_on_divergence=fault_on_divergence,
            surrogate=config.surrogate, use_prior=bank is not None)
        self._pools = [
            _LanePool(i, width, self,
                      self.device if self.devices is None
                      else self.devices[i % len(self.devices)])
            for i in range(n_shards)]
        self._requests: dict = {}   # arrival index -> Scenario
        self._staged: dict = {}     # arrival index -> staging dict
        self._n_pulled = 0
        self._feed_done = False
        self._served = False
        self._stats: dict = {}
        # fault tolerance ----------------------------------------------------
        self.admission_policy = admission_policy
        self.shed_hopeless = bool(shed_hopeless)
        self.shed_safety = float(shed_safety)
        self.quarantine = quarantine
        self.max_requeues = int(max_requeues)
        # overload tolerance ---------------------------------------------------
        self.elastic = bool(elastic)
        self.n_lanes_min = n_lanes_min
        self.n_lanes_max = n_lanes_max
        self._w_min = n_lanes_min // n_shards
        self._w_max = n_lanes_max // n_shards
        self.max_pending = (None if max_pending is None
                            else int(max_pending))
        self.overload = overload
        self.routing = routing
        self.route_backoff_s = float(route_backoff_s)
        self.route_max_retries = int(route_max_retries)
        self._overflow: deque = deque()   # host-side results awaiting yield
        self._resize_log: deque = deque(maxlen=self.STATS_TRACE_CAP)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.ckpt_keep = int(ckpt_keep)
        self.chaos = chaos
        self.monitor = (None if heartbeat_timeout_s is None else
                        HeartbeatMonitor(
                            n_shards, dead_timeout_s=heartbeat_timeout_s))
        # the quarantine ladder: one rung per fault of the same request
        self._rungs = ((("requeue",) * self.max_requeues
                        if quarantine == "requeue" else ())
                       + ("reseed", "scrub", "retire"))
        self._qlevel: dict = {}     # arrival index -> faults seen so far
        self._degraded: dict = {}   # arrival index -> DEGRADED_REASONS entry
        self._emitted: set = set()  # emission watermark (resume dedup)
        self._pending: deque = deque()
        self._round = 0
        self._rr = 0
        self._ewma_iter_s: Optional[float] = None
        self._restore: Optional[dict] = None
        self._n_evals_total = 0
        self._counters = dict(
            n_faults=0, n_requeued=0, n_preempted=0, n_shed=0,
            n_degraded=0, n_pool_drops=0, n_checkpoints=0,
            deadline_total=0, deadline_hits=0,
            n_rejected=0, n_overflow_shed=0, n_grows=0, n_shrinks=0,
            n_backoffs=0, n_rebalanced=0,
            # acquisition iterations and the LANE_WIDTH chunks they
            # computed (one matern_posterior launch each on the card)
            acq_iters=0, acq_chunks=0)

    # -- feed ----------------------------------------------------------------
    def _oversized(self, sc: Scenario) -> str:
        """Why this request cannot be served at the engine's static
        shapes (empty string when it can). Oversized requests are not
        an error — a live feed cannot be pre-screened — they emit a
        degraded result with reason ``"rejected"`` instead of killing
        the serve loop."""
        if sc.budget > self.budget_max:
            return (f"budget {sc.budget} exceeds the server "
                    f"budget_max={self.budget_max}")
        if sc.problem.L > self.l_pad:
            return (f"L={sc.problem.L} exceeds the server "
                    f"l_pad={self.l_pad}")
        return ""

    def _arrived(self, i: int, now: float) -> bool:
        if self.arrivals is None or i >= len(self.arrivals):
            return True
        return self.arrivals[i] * self.time_scale <= now

    def _pull(self, pending: deque, now: float) -> None:
        """Move arrived requests from the feed into the admission queue.

        Order-driven feeds (no ``arrivals``) are pulled lazily — only
        enough to refill every currently free lane plus one pool-flush
        of look-ahead (the staging of look-ahead requests hides under
        the running device phase) — so generator feeds are consumed on
        demand; timed feeds pull everything whose arrival time has
        passed.

        ``max_pending`` bounds the queue: once it is full, the
        ``overload`` policy decides — ``"block"`` stops pulling (pure
        backpressure: arrivals wait in the feed), ``"reject"`` answers
        each excess arrival with an immediate degraded result, and
        ``"shed-oldest"`` evicts the oldest hopeless queued request
        (falling back to the oldest outright) to make room. Every
        pulled request still emits exactly one result. Oversized
        requests (``_oversized``) are rejected here regardless of
        queue state. Degraded results produced here land in
        ``self._overflow``; the serve loop drains it right after each
        pull."""
        if self._feed_done:
            return
        free = sum(p.free_count() for p in self._pools)
        cap = self.max_pending
        while True:
            if (self.arrivals is None
                    and len(pending) >= free + self.n_lanes):
                return
            if (cap is not None and self.overload == "block"
                    and len(pending) >= cap):
                return
            if not self._arrived(self._n_pulled, now):
                return
            try:
                sc = next(self._feed)
            except StopIteration:
                self._feed_done = True
                return
            i = self._n_pulled
            self._n_pulled += 1
            why = self._oversized(sc)
            if why:
                self._counters["n_rejected"] += 1
                self._overflow.append(self._host_result(
                    i, sc, self._now_trace(now), "rejected"))
                continue
            if cap is not None and len(pending) >= cap:
                now_trace = self._now_trace(now)
                if self.overload == "reject":
                    self._counters["n_rejected"] += 1
                    self._overflow.append(self._host_result(
                        i, sc, now_trace, "rejected"))
                    continue
                # "shed-oldest": hopeless-first eviction keeps the
                # bound while spending it on the request EDF would
                # have wasted a lane on anyway
                victim = 0
                for k, (_, vsc) in enumerate(pending):
                    if self._hopeless(vsc, now_trace):
                        victim = k
                        break
                vidx, vsc = pending[victim]
                del pending[victim]
                self._counters["n_overflow_shed"] += 1
                self._overflow.append(self._host_result(
                    vidx, vsc, now_trace, "shed"))
            self._requests[i] = sc
            pending.append((i, sc))

    def _stage_request(self, idx: int, sc: Scenario) -> dict:
        """Per-request host staging, cached so the pre-staging pass that
        runs while a device phase is in flight does the work once."""
        st = self._staged.pop(idx, None)
        if st is None:
            st = wr.stage_scenario(sc, self.l_pad, self.n_init,
                                   self.constraint_aware, self.grid_np[:1],
                                   bank=self.bank, device=self.device)
        return st

    def _prestage(self, pending: deque) -> None:
        """Stage every queued request now (called right after dispatch,
        so the host staging work overlaps the running device phase)."""
        for idx, sc in pending:
            if idx not in self._staged:
                self._staged[idx] = wr.stage_scenario(
                    sc, self.l_pad, self.n_init, self.constraint_aware,
                    self.grid_np[:1], bank=self.bank, device=self.device)

    # -- fault handling ------------------------------------------------------
    def _handle_fault(self, pool: _LanePool, lane: int,
                      pending: deque) -> None:
        """Run one rung of the quarantine ladder on a faulted lane. The
        rung index is the request's fault count so far, so a request
        that keeps diverging walks requeue^k -> re-seed -> scrub ->
        degraded retirement and can never wedge the pool."""
        idx = int(pool.order[lane])
        self._counters["n_faults"] += 1
        level = self._qlevel.get(idx, 0)
        self._qlevel[idx] = level + 1
        action = self._rungs[min(level, len(self._rungs) - 1)]
        if action == "requeue":
            # free the lane (the admission scatter fully re-initializes
            # it) and re-run the request from scratch — a clean cold
            # run, so recovery replay-matches the fault-free schedule
            self._counters["n_requeued"] += 1
            pool.order[lane] = -1
            pending.append((idx, self._requests[idx]))
        elif action == "reseed":
            pool.repair([lane], scrub=False)
        elif action == "scrub":
            pool.repair([lane], scrub=True)
        else:
            self._degraded.setdefault(idx, "quarantine")
            pool.retire([lane])

    def _drop_pool(self, pool_id: int, reason: str = "") -> None:
        """Pool loss: mark the pool dead and re-enqueue its in-flight
        requests (bounded re-execution — one re-run per drop event);
        they re-admit onto surviving pools on the next round."""
        p = self._pools[pool_id]
        if p.dead:
            return
        p.dead = True
        self._counters["n_pool_drops"] += 1
        for r in range(p.width):
            idx = int(p.order[r])
            if idx >= 0:
                # a fresh full run supersedes any degraded verdict
                self._degraded.pop(idx, None)
                self._pending.append((idx, self._requests[idx]))
                p.order[r] = -1

    # -- deadlines -----------------------------------------------------------
    def _now_trace(self, now_wall: float) -> float:
        return now_wall / self.time_scale if self.time_scale > 0 else 0.0

    def _hopeless(self, sc: Scenario, now_trace: float,
                  remaining_evals: Optional[int] = None) -> bool:
        """Deadline triage: already past it, or the EWMA-estimated
        remaining work (queued requests: the full post-init loop)
        cannot land before it."""
        d = sc.deadline_s
        if d is None:
            return False
        if now_trace >= d:
            return True
        ew = self._ewma_iter_s
        if ew is None:
            return False
        rem = (max(1, sc.budget - self.n_init)
               if remaining_evals is None else max(1, remaining_evals))
        est = self.shed_safety * rem * self._now_trace(ew)
        return now_trace + est > d

    def _host_result(self, idx: int, sc: Scenario, now_trace: float,
                     reason: str) -> StreamResult:
        """Degraded answer produced host-side, no lane ever consumed:
        the feasible projection of the search-space center. Shared by
        queue shedding (``reason="shed"``), overload rejection and
        oversized-request rejection (``reason="rejected"``)."""
        self._requests.pop(idx, None)
        self._staged.pop(idx, None)
        return host_degraded_result(idx, sc, now_trace, reason)

    def _preempt(self, now_trace: float) -> None:
        """Retire in-flight lanes whose deadlines are unmeetable; the
        next flush emits their best-effort incumbents as degraded
        results, and the lanes free for requests that can still win."""
        if self._ewma_iter_s is None:
            return
        for p in self._pools:
            if p.dead or p.state is None:
                continue
            vals = wr._host(torch.stack([p.state["active"].to(torch.int32),
                                         p.state["n"]]))
            active, n = vals[0].astype(bool), vals[1]
            doomed = []
            for r in range(p.width):
                idx = int(p.order[r])
                if idx < 0 or not active[r]:
                    continue
                sc = self._requests.get(idx)
                if sc is None or sc.deadline_s is None:
                    continue
                rem = int(sc.budget - n[r])
                if rem > 0 and self._hopeless(sc, now_trace, rem):
                    doomed.append(r)
                    self._degraded.setdefault(idx, "preempted")
            if doomed:
                self._counters["n_preempted"] += len(doomed)
                p.retire(doomed)

    # -- elastic pool sizing ---------------------------------------------------
    def _elastic_step(self, n_pending: int) -> None:
        """Hysteresis controller: grow a pool when its share of the
        queue has exceeded its free capacity (current free lanes plus
        the EWMA lane-free rate) for ``ELASTIC_GROW_PATIENCE``
        consecutive rounds; shrink when the queue is empty and the pool
        has sat at <= quarter occupancy for ``ELASTIC_SHRINK_PATIENCE``
        rounds. Power-of-2 steps inside [``n_lanes_min``,
        ``n_lanes_max``] per shard, with a post-resize cooldown so the
        controller can observe the new width before moving again."""
        alive = [p for p in self._pools if not p.dead]
        if not alive:
            return
        share = -(-n_pending // len(alive))      # ceil queue share
        for p in alive:
            if p.cool > 0:
                p.cool -= 1
                p.hot = p.cold = 0
                continue
            occ = int(np.sum(p.order >= 0))
            free = p.width - occ
            p.hot = (p.hot + 1 if (p.width < self._w_max
                                   and share > free + p.ewma_free)
                     else 0)
            p.cold = (p.cold + 1 if (n_pending == 0
                                     and p.width > self._w_min
                                     and occ <= p.width // 4)
                      else 0)
            new = None
            if p.hot >= self.ELASTIC_GROW_PATIENCE:
                new = min(self._w_max, p.width * 2)
                self._counters["n_grows"] += 1
            elif p.cold >= self.ELASTIC_SHRINK_PATIENCE:
                new = max(self._w_min,
                          wr._next_pow2(max(1, 2 * occ)))
                if new >= p.width:
                    new = None
                else:
                    self._counters["n_shrinks"] += 1
            if new is not None and new != p.width:
                old = p.width
                p.resize_to(new)
                p.hot = p.cold = 0
                p.cool = self.ELASTIC_COOLDOWN
                self._resize_log.append(dict(
                    round=self._round, pool=p.pool_id,
                    width=(old, new), pending=n_pending))

    # -- failover routing -------------------------------------------------------
    def _failover_step(self, now: float) -> None:
        """Back unhealthy pools off the admission path. A pool is
        unhealthy while its heartbeat is muted, or while its EWMA
        dispatch wall exceeds ``ROUTE_STRAGGLER_X`` times the median of
        the other alive pools (a 2-pool fleet can't use the monitor's
        MAD rule). Each strike doubles the backoff window
        (``route_backoff_s`` base); the second strike also rebalances
        the pool's in-flight work onto the healthy pools, and a strike
        past ``route_max_retries`` hands the pool to the established
        drop-pool path. A pool that looks healthy again after its
        window resets to a clean slate. Only engaged with a
        ``HeartbeatMonitor`` armed — health is the monitor subsystem's
        verdict, and a server without one never backs a pool off."""
        alive = [p for p in self._pools if not p.dead]
        if len(alive) < 2:
            return
        for p in alive:
            slow = False
            if p.ewma_wall is not None:
                others = [q.ewma_wall for q in alive
                          if q is not p and q.ewma_wall is not None]
                slow = bool(others) and (
                    p.ewma_wall
                    > self.ROUTE_STRAGGLER_X * float(np.median(others)))
            if p.muted or slow:
                if now < p.backoff_until:
                    continue         # strike already counted
                p.backoff_level += 1
                self._counters["n_backoffs"] += 1
                if p.backoff_level > self.route_max_retries:
                    self._drop_pool(p.pool_id,
                                    reason="backoff-exhausted")
                    continue
                p.backoff_until = now + (self.route_backoff_s
                                         * 2.0 ** (p.backoff_level - 1))
                if p.backoff_level >= 2:
                    self._rebalance_pool(p)
            elif p.backoff_level and now >= p.backoff_until:
                p.backoff_level = 0  # recovered

    def _rebalance_pool(self, p: _LanePool) -> None:
        """Move a struggling pool's in-flight (active) requests back to
        the admission queue so healthy pools can serve them: the lanes
        retire device-side but their rows never flush (``order`` clears
        first), and each re-run is an ordinary fresh cold run — the
        same bounded-re-execution argument as the requeue and drop-pool
        paths, so rebalancing never perturbs the replay contract.
        Faulted and retired-but-unflushed lanes stay: the quarantine
        ladder and the flush own those."""
        if p.state is None:
            return
        active = wr._host(p.state["active"])
        moved = []
        for r in range(p.width):
            idx = int(p.order[r])
            if idx < 0 or not active[r]:
                continue
            self._degraded.pop(idx, None)
            self._pending.append((idx, self._requests[idx]))
            p.order[r] = -1
            moved.append(r)
        if moved:
            p.retire(moved)
            self._counters["n_rebalanced"] += len(moved)

    def _route_features(self, now: float) -> List[dict]:
        """Per-pool routing features for ``route_admission_shard``.
        EWMA walls are only exposed for pools carrying backoff strikes:
        on a healthy fleet every score stays the integer free-lane
        count, so routing is deterministic and reduces exactly to the
        historical most-free/round-robin placement."""
        feats = []
        for p in self._pools:
            f = dict(free=0 if (p.dead or p.muted) else p.free_count(),
                     backoff=bool(p.dead or p.muted
                                  or now < p.backoff_until))
            if p.backoff_level > 0:
                f["ewma_wall_s"] = p.ewma_wall
            if self.monitor is not None and not p.dead:
                grace = 0.5 * self.monitor.dead_timeout_s
                stale = self.monitor.clock() - self.monitor.last_seen[p.pool_id]
                if stale > grace > 0:
                    f["stale_frac"] = stale / grace - 1.0
            feats.append(f)
        return feats

    # -- checkpoint / restore ------------------------------------------------
    def _meta(self) -> dict:
        return dict(
            n_lanes=self.n_lanes, n_shards=self.n_shards,
            l_pad=self.l_pad, budget_max=self.budget_max,
            n_init=self.n_init, time_scale=self.time_scale,
            quarantine=self.quarantine, max_requeues=self.max_requeues,
            policy=(self.admission_policy
                    if isinstance(self.admission_policy, str)
                    else "custom"),
            elastic=self.elastic, n_lanes_min=self.n_lanes_min,
            n_lanes_max=self.n_lanes_max, max_pending=self.max_pending,
            overload=self.overload, routing=self.routing,
            pool_widths=[p.width for p in self._pools],
            has_bank=self.bank is not None,
            round=self._round)

    def _ckpt_tree(self) -> dict:
        pools = {}
        for p in self._pools:
            pt = dict(order=p.order.copy(), gen=p.gen.copy(),
                      lane_ids=p.lane_ids.copy(),
                      it=np.int64(p.it_host), dead=np.int8(p.dead),
                      has_state=np.int8(p.state is not None),
                      # elastic geometry/controller: widths round-trip
                      # through the array shapes; the id counter and
                      # hysteresis state ride alongside
                      lane_seq=np.int64(p._lane_seq),
                      ewma_free=np.float64(p.ewma_free),
                      hot=np.int64(p.hot), cold=np.int64(p.cold),
                      cool=np.int64(p.cool))
            if p.state is not None:
                pt["state"] = ckptlib._map_leaves(
                    lambda _, v: wr._host(v), p.state)
                pt["run_data"] = ckptlib._map_leaves(
                    lambda _, v: wr._host(v), p.run_data)
            pools[str(p.pool_id)] = pt
        ql = sorted(self._qlevel)
        dg = sorted(self._degraded)
        queue = dict(
            pending=np.asarray([i for i, _ in self._pending], np.int64),
            emitted=np.asarray(sorted(self._emitted), np.int64),
            n_pulled=np.int64(self._n_pulled),
            rr=np.int64(self._rr),
            qlevel_idx=np.asarray(ql, np.int64),
            qlevel_n=np.asarray([self._qlevel[i] for i in ql], np.int64),
            degraded_idx=np.asarray(dg, np.int64),
            degraded_code=np.asarray(
                [DEGRADED_REASONS.index(self._degraded[i]) for i in dg],
                np.int64))
        tree = dict(pools=pools, queue=queue)
        if self.bank is not None:
            # the learned priors ride the serving snapshot: kill +
            # resume carries the bank (tests/test_torch_stream.py)
            tree["bank"] = self.bank.state_tree()
        return tree

    def checkpoint_now(self) -> int:
        """Force a snapshot of the full serving state (pool pytrees +
        host lane maps + admission queue + emitted watermark) — the
        SIGTERM/drain hook. Returns the checkpoint step (the current
        serving round). Atomic: a crash mid-save leaves the previous
        commit intact (``checkpoint/ckpt.py``)."""
        if not self.ckpt_dir:
            raise ValueError("no ckpt_dir configured")
        ckptlib.save(self.ckpt_dir, self._round, self._ckpt_tree(),
                     metadata=dict(stream=self._meta()), blocking=True)
        self._counters["n_checkpoints"] += 1
        self._gc_ckpts()
        return self._round

    def _gc_ckpts(self) -> None:
        import os
        import shutil
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.ckpt_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _maybe_checkpoint(self) -> None:
        if (self.ckpt_dir and self.ckpt_every
                and self._round % self.ckpt_every == 0):
            self.checkpoint_now()

    @classmethod
    def resume(cls, ckpt_dir: str, requests: Iterable[Scenario],
               step: Optional[int] = None,
               **kw) -> "StreamingBayesSplitEdge":
        """Rebuild a server from its latest (or given) committed
        checkpoint. ``requests`` must replay the SAME feed the crashed
        server consumed (feeds are replayable by construction — traces
        and seeded generators); the consumed prefix is replayed to
        recover in-flight/queued Scenarios, and serving continues from
        the snapshot. Static server shapes in ``kw`` must match the
        checkpoint (``ValueError`` otherwise — restoring onto a
        different ``n_shards`` is not supported); unspecified ones are
        taken from it. Emission is at-least-once across the crash:
        results emitted after the snapshot re-emit —
        :func:`dedup_results` restores exactly-once."""
        if step is None:
            step = ckptlib.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {ckpt_dir}")
        man = ckptlib.load_manifest(ckpt_dir, step)
        meta = man.get("metadata", {}).get("stream")
        if meta is None:
            raise ValueError(f"{ckpt_dir} step {step} is not a "
                             f"streaming-engine checkpoint")
        static = ("n_lanes", "n_shards", "l_pad", "budget_max")
        bad = {k: (kw[k], meta[k]) for k in static
               if k in kw and kw[k] != meta[k]}
        # n_init is a static shape too, but lives on the EngineConfig
        # (or the legacy n_init= keyword the shim folds over it)
        cfg_in = kw.get("config")
        given_n_init = kw.get(
            "n_init", None if cfg_in is None else cfg_in.n_init)
        if given_n_init is not None and given_n_init != meta["n_init"]:
            bad["n_init"] = (given_n_init, meta["n_init"])
        if bad:
            raise ValueError(
                "checkpoint/engine config mismatch — the serving state "
                "is bound to its static shapes: "
                + ", ".join(f"{k}: given {g} vs checkpointed {c}"
                            for k, (g, c) in bad.items()))
        for k in static:
            kw.setdefault(k, meta[k])
        if cfg_in is None and "n_init" not in kw:
            kw["config"] = EngineConfig(n_init=meta["n_init"])
        if meta.get("has_bank") and kw.get("bank") is None:
            # the snapshot carries a prior bank: arm an empty one so the
            # rebuilt programs keep use_prior and _install can refill it
            kw["bank"] = PriorBank()
        kw.setdefault("time_scale", meta["time_scale"])
        kw.setdefault("quarantine", meta["quarantine"])
        kw.setdefault("max_requeues", meta["max_requeues"])
        # overload-tolerance config (absent in pre-elastic checkpoints)
        for k in ("elastic", "n_lanes_min", "n_lanes_max",
                  "max_pending", "overload", "routing"):
            if meta.get(k) is not None:
                kw.setdefault(k, meta[k])
        kw.setdefault("ckpt_dir", ckpt_dir)
        eng = cls(requests, **kw)
        eng._install(ckptlib.load_flat(ckpt_dir, step))
        eng._round = int(meta["round"])
        return eng

    def _install(self, flat: dict) -> None:
        t = ckptlib.unflatten(flat)
        for p in self._pools:
            pt = t["pools"][str(p.pool_id)]
            p.order = np.asarray(pt["order"], np.int64)
            p.gen = np.asarray(pt["gen"], np.int64)
            p.lane_ids = np.asarray(pt["lane_ids"], np.int64)
            # elastic geometry round-trips through the array shapes:
            # a pool resumes at its checkpointed width, whatever the
            # construction-time nominal was
            p.width = int(p.order.shape[0])
            p._lane_seq = int(pt.get(
                "lane_seq",
                p.lane_ids.max() + 1 if p.lane_ids.size else 0))
            p.ewma_free = float(pt.get("ewma_free", 0.0))
            p.hot = int(pt.get("hot", 0))
            p.cold = int(pt.get("cold", 0))
            p.cool = int(pt.get("cool", 0))
            p.dead = bool(pt["dead"])
            it = int(pt["it"])
            p.it, p.it_host = it, it
            if int(pt["has_state"]):
                def put(_, x, dev=p.device):
                    return torch.as_tensor(np.array(x), device=dev)
                p.state = ckptlib._map_leaves(put, pt["state"])
                p.run_data = ckptlib._map_leaves(put, pt["run_data"])
        if self.bank is not None and "bank" in t:
            self.bank.load_state(t["bank"])
        q = t["queue"]
        self._emitted = set(int(i) for i in q["emitted"])
        self._qlevel = {int(i): int(n) for i, n in
                        zip(q["qlevel_idx"], q["qlevel_n"])}
        self._degraded = {int(i): DEGRADED_REASONS[int(c)] for i, c in
                          zip(q["degraded_idx"], q["degraded_code"])}
        self._restore = dict(
            pending=[int(i) for i in q["pending"]],
            n_pulled=int(q["n_pulled"]), rr=int(q["rr"]))

    def _replay_feed(self, pending: deque) -> None:
        """Re-derive the host Scenario table from the feed: pull the
        checkpointed number of requests and keep the ones still live
        (queued, in-flight, or retired-but-unflushed)."""
        info, self._restore = self._restore, None
        needed = set(info["pending"]) | set(self._degraded)
        for p in self._pools:
            needed.update(int(i) for i in p.order if i >= 0)
        for j in range(info["n_pulled"]):
            try:
                sc = next(self._feed)
            except StopIteration:
                raise ValueError(
                    "resume feed is shorter than the checkpointed pull "
                    "count — resume() must replay the same feed")
            if j in needed:
                # oversized requests are never "needed": they were
                # rejected (degraded result) the round they were
                # pulled, before any snapshot could owe them state
                self._requests[j] = sc
        self._n_pulled = info["n_pulled"]
        self._rr = info["rr"]
        for i in info["pending"]:
            pending.append((i, self._requests[i]))

    # -- the server loop -----------------------------------------------------
    def serve(self) -> Iterator[StreamResult]:
        if self._served:
            raise RuntimeError("serve() already consumed this engine's "
                               "feed — build a new engine to replay")
        self._served = True
        pending = self._pending
        if self._restore is not None:
            self._replay_feed(pending)
        # per-dispatch traces are bounded so an unbounded feed doesn't
        # grow host memory; the aggregate stats accumulate separately
        lane_log: deque = deque(maxlen=self.STATS_TRACE_CAP)
        queue_depth: deque = deque(maxlen=self.STATS_TRACE_CAP)
        n_results = n_dispatches = slots_total = n_flushed = 0
        counts0 = dict(wr._counts)
        qd_sum = qd_n = qd_max = 0
        t0 = time.monotonic()
        c = self._counters

        def emit(res):
            nonlocal n_results
            n_results += 1
            self._n_evals_total += res.result.n_evals
            self._emitted.add(res.index)
            if res.degraded:
                c["n_degraded"] += 1
            if res.scenario.deadline_s is not None:
                c["deadline_total"] += 1
                if (not res.degraded
                        and res.emit_s <= res.scenario.deadline_s):
                    c["deadline_hits"] += 1
            if self.on_result is not None:
                self.on_result(res)

        def flush(pool, entry=None):
            nonlocal n_dispatches, slots_total, n_flushed
            flushed, faulted, iters = pool.collect()
            if entry is not None:
                entry["iters"] = iters
                wall = time.monotonic() - entry.pop("t0")
                entry["wall_s"] = wall
                if iters > 0:
                    x = wall / iters
                    self._ewma_iter_s = (
                        x if self._ewma_iter_s is None
                        else 0.3 * x + 0.7 * self._ewma_iter_s)
                # per-pool health/elasticity signals: the EWMA dispatch
                # wall feeds the routing score and straggler test (and
                # the monitor, as this pool's real step time); the EWMA
                # free rate feeds the elastic grow decision
                pool.ewma_wall = (wall if pool.ewma_wall is None
                                  else 0.3 * wall + 0.7 * pool.ewma_wall)
                pool.ewma_free = (0.3 * len(flushed)
                                  + 0.7 * pool.ewma_free)
                if self.monitor is not None and not pool.muted:
                    self.monitor.report(pool.pool_id, wall)
                lane_log.append(entry)
                n_dispatches += 1
                slots_total += entry["lanes"] * iters
                c["acq_iters"] += entry["acq_iters"]
                c["acq_chunks"] += entry["acq_iters"] * entry["chunks"]
            for lane in faulted:
                self._handle_fault(pool, lane, pending)
            now_trace = self._now_trace(time.monotonic() - t0)
            for res in flushed:
                res.emit_s = now_trace
                n_flushed += 1
                emit(res)
                yield res

        while True:
            self._round += 1
            now = time.monotonic() - t0
            # snapshot FIRST: a crash anywhere in the round (chaos's
            # kill model) resumes from a commit no older than one round
            self._maybe_checkpoint()
            if self.monitor is not None:
                for p in self._pools:
                    if not p.dead and not p.muted:
                        # liveness-only ping: real step times reach the
                        # monitor from the dispatch flush, so the
                        # straggler statistics stay meaningful
                        self.monitor.heartbeat(p.pool_id)
                for h in self.monitor.dead():
                    self._drop_pool(h, reason="heartbeat-timeout")
                if self.routing == "score":
                    # failover ladder: backoff -> rebalance -> drop,
                    # all BEFORE the hard heartbeat timeout would fire
                    self._failover_step(now)
            else:
                # a muted pool can only ever be detected by the
                # monitor; without one, drop it immediately
                for p in self._pools:
                    if p.muted and not p.dead:
                        self._drop_pool(p.pool_id, reason="muted")
            self._pull(pending, now)
            while self._overflow:
                # host-side degraded answers minted by the pull
                # (oversized/overload rejections, overflow sheds)
                res = self._overflow.popleft()
                emit(res)
                yield res
            if self.shed_hopeless and pending:
                # triage BEFORE admission: a request that cannot make
                # its deadline must not take a lane from one that can
                now_trace = self._now_trace(time.monotonic() - t0)
                keep = deque()
                for idx, sc in pending:
                    if self._hopeless(sc, now_trace):
                        c["n_shed"] += 1
                        res = self._host_result(idx, sc, now_trace,
                                                "shed")
                        emit(res)
                        yield res
                    else:
                        keep.append((idx, sc))
                pending = self._pending = keep
            if self.elastic:
                # resize BEFORE admission so this round's fills see the
                # new width (grow under pressure, shrink when idle)
                self._elastic_step(len(pending))
            # policy-ordered admission into the best shard — requests
            # bind to exactly one pool, so the multi-pool path stays
            # collective-free. "score" places by free capacity
            # discounted by health (EWMA dispatch wall, heartbeat
            # staleness, backoff); on a healthy fleet it reduces
            # exactly to the historical most-free/round-robin ("rr").
            fills: dict = {i: [] for i in range(self.n_shards)}
            if pending:
                queue = list(pending)
                sel = admission_order(queue, self._now_trace(now),
                                      self.admission_policy)
                feats = (self._route_features(now)
                         if self.routing == "score" else None)
                wall_ref = None
                if feats is not None:
                    walls = [p.ewma_wall for p in self._pools
                             if not p.dead and p.ewma_wall is not None]
                    wall_ref = (float(np.median(walls))
                                if walls else None)
                taken = set()
                for j in sel:
                    if feats is not None:
                        for p in self._pools:
                            if not (p.dead or p.muted):
                                feats[p.pool_id]["free"] = (
                                    p.free_count()
                                    - len(fills[p.pool_id]))
                        shard = route_admission_shard(
                            feats, self._rr, wall_ref=wall_ref)
                    else:
                        free = [p.free_count() - len(fills[p.pool_id])
                                for p in self._pools]
                        shard = next_admission_shard(free, self._rr)
                    if shard is None:
                        break
                    self._rr = (shard + 1) % self.n_shards
                    fills[shard].append(queue[j])
                    taken.add(j)
                if taken:
                    pending = self._pending = deque(
                        q for k, q in enumerate(queue) if k not in taken)
            for i, reqs in fills.items():
                if reqs:
                    self._pools[i].admit(reqs)
            if pending and all(p.dead for p in self._pools):
                raise RuntimeError(
                    "all lane pools lost — cannot serve the queue")
            # inject AFTER admission so poison/drop faults see the
            # round's in-flight lanes; the kill model still crashes
            # between the round's checkpoint and its dispatches (the
            # admissions above are device-state only — the snapshot
            # keeps those requests pending, so resume re-admits them)
            if self.chaos is not None:
                self.chaos.inject(self)     # may raise SimulatedCrash
            if self.shed_hopeless:
                self._preempt(self._now_trace(time.monotonic() - t0))
            queue_depth.append(len(pending))
            qd_sum += len(pending)
            qd_n += 1
            qd_max = max(qd_max, len(pending))
            # lanes whose budget <= n_init retire at the init design —
            # flush them (plus preempted/quarantine-retired lanes)
            # before (possibly instead of) any dispatch. A muted pool
            # is a hung host: it delivers nothing and frees no lane, so
            # its work waits for the heartbeat verdict (drop -> requeue
            # onto a survivor) or for the pool to come back
            for p in self._pools:
                if not p.muted:
                    yield from flush(p)
            draining = self._feed_done and not pending
            dispatched = []
            for p in self._pools:
                if p.dead or p.muted:
                    continue
                if p.live_count() > 0:
                    # timing starts BEFORE the chaos hook: an injected
                    # straggler delay is exactly the slow-host cost the
                    # per-pool EWMA wall is supposed to see
                    t_d = time.monotonic()
                    if self.chaos is not None:
                        self.chaos.on_dispatch(self, p)
                    entry = p.dispatch(draining=draining)
                    if entry is not None:
                        entry["queue_depth"] = len(pending)
                        entry["t0"] = t_d
                        dispatched.append((p, entry))
            # the device phases are in flight: overlap the host-side
            # pull + staging of the queue with them
            self._pull(pending, time.monotonic() - t0)
            self._prestage(pending)
            for p, entry in dispatched:
                yield from flush(p, entry)
            while self._overflow:
                res = self._overflow.popleft()
                emit(res)
                yield res
            if not dispatched:
                inflight = any(
                    bool(np.any(p.order >= 0)) for p in self._pools
                    if not p.dead)
                if self._feed_done and not pending and not inflight:
                    break
                if inflight:
                    # only unreachable (muted) pools hold work — wait
                    # for the heartbeat verdict instead of busy-spinning
                    time.sleep(0.005)
                elif pending:
                    # every pool is in its failover backoff window —
                    # wait it out instead of busy-spinning
                    time.sleep(0.002)
                elif not pending and self.arrivals is not None:
                    # idle server: sleep until the next arrival
                    t_next = (self.arrivals[self._n_pulled]
                              * self.time_scale
                              if self._n_pulled < len(self.arrivals)
                              else 0.0)
                    dt = t_next - (time.monotonic() - t0)
                    if dt > 0:
                        time.sleep(dt)
            elif self._feed_done and not pending:
                # drain mode: no admissions left — shrink pools so the
                # tail doesn't pay for freed lanes
                for p in self._pools:
                    if not p.dead:
                        p.shrink()

        wall = time.monotonic() - t0
        # loop evals from the flushed results themselves (every retired
        # request's post-init evaluations): lane_log's per-dispatch
        # `live` is the ENTRY count, which overcounts draining
        # dispatches where lanes retire mid-phase
        evals = self._n_evals_total - self.n_init * n_flushed
        self._stats = dict(
            n_results=n_results, n_dispatches=n_dispatches,
            lane_slots=slots_total, loop_evals=evals,
            occupancy_mean=(evals / slots_total if slots_total else 1.0),
            queue_depth_mean=(qd_sum / qd_n if qd_n else 0.0),
            queue_depth_max=qd_max,
            wall_s=wall,
            arrivals_per_s=(n_results / wall if wall > 0 else 0.0),
            rounds=self._round,
            deadline_hit_rate=(
                c["deadline_hits"] / c["deadline_total"]
                if c["deadline_total"] else 1.0),
            max_pending=self.max_pending,
            pool_widths=[p.width for p in self._pools],
            **dict(c),
            # bounded traces (the STATS_TRACE_CAP most recent entries)
            lane_log=list(lane_log), queue_depth=list(queue_depth),
            resize_log=list(self._resize_log),
            # the serving loop's device-to-host reads
            host_reads=wr._counts["host_reads"] - counts0["host_reads"])

    def run(self) -> List[BOResult]:
        """Drain the whole feed; results in arrival order (the newly
        emitted indices — a resumed server returns what IT emitted;
        merge with the pre-crash emissions via ``dedup_results``)."""
        out = {}
        for r in self.serve():
            out[r.index] = r.result
        return [out[i] for i in sorted(out)]

    def stream_stats(self) -> dict:
        """Serving-loop accounting of the last ``serve``/``run``:
        dispatch count, lane-slot occupancy (live-lane evals over
        computed lane slots), queue-depth trajectory and arrival
        throughput, the per-dispatch lane log, plus the fault-tolerance
        counters (faults, requeues, preemptions, sheds, pool drops,
        checkpoints, deadline hit rate)."""
        return dict(self._stats)
