"""Deterministic fault injection for the streaming serving engine: the
port's counterpart of ``repro/runtime/chaos.py``. The fault schedule,
its rng stream and its event log are the reference's; the two lane
poisons are plain torch functions that return a new state dict and
write no tensor in place (a pool keeps references to its state).

The fault-tolerance layer (checkpoint/restore, divergence quarantine,
deadline shedding, pool-loss recovery — ``runtime/stream.py``) is
validated by *active* fault injection rather than trusted by
construction: a seeded ``FaultInjector`` attached to a
``StreamingBayesSplitEdge`` fires a configured fault schedule against
the live server, and the recovery invariants (post-dedup replay match
vs the fault-free run, bounded re-execution, no wedges) are gated in
``tests/test_torch_chaos.py`` and ``chip_smoke.py`` phase 4c.

Fault classes (all one-shot per configured entry, all logged to an
``events`` list that dumps to JSON for CI artifacts):

* ``kill_at`` — raise :class:`SimulatedCrash` at the top of the given
  serving rounds, after the round's checkpoint: the process-death model
  for the checkpoint/``resume()`` replay-match invariant.
* ``nan_poison_at`` — overwrite a live lane's GP observations (or its
  hyperparameter carry, ``poison="theta"``) with NaN: the diverged-fit
  model driving the quarantine ladder (requeue / re-seed -> scrub ->
  degraded retirement).
* ``drop_pool_at`` — kill a lane pool outright (host loss): its
  in-flight requests must re-enter the admission queue and re-admit
  onto surviving pools.
* ``mute_pool_at`` — silence a pool's heartbeat without freeing it (the
  hung-host model): detection must come from the ``HeartbeatMonitor``
  timeout, not from the injector.
* ``delay_at`` — sleep ``delay_s`` before the round's dispatches (the
  straggler model for heartbeat/overhead studies).
* ``storm_at`` — arrival storm (the flash-crowd model for the bounded
  admission queue): collapse the arrival times of the next ``storm_n``
  not-yet-pulled feed entries to "now", so they all land in one round's
  pull regardless of the trace's pacing.
* ``flap_at`` — flapping pool: mute a pool's heartbeat for
  ``flap_rounds`` serving rounds, then un-mute it (the
  recovers-before-the-dead-timeout model that exercises failover
  routing/backoff rather than the drop-pool path).
* ``slow_pool_at`` — persistent straggler: one pool's dispatches each
  pay an extra ``slow_s`` sleep for ``slow_rounds`` rounds (vs the
  one-shot ``delay_at``) — the slow-host model the routing score and
  work-rebalancing respond to.

Every random choice (which pool, which lane) comes from one
``numpy.random.default_rng(seed)`` stream in firing order, so a chaos
schedule is fully determined by ``(seed, schedule)`` and a failing run
replays exactly: :func:`FaultInjector.save_events` /
:func:`load_events` round-trip the event log as JSON for CI artifacts.

The fleet transport layer (``runtime/fleet.py``) has its own fault
model, :class:`NetworkChaos`: per-message drop/duplicate/reorder/bounded
delay plus scheduled one-way link partitions and heals, all drawn from
one seeded rng in send order so a network-failure scenario is as
replayable as the engine faults above. ``kill_router_at`` raises
:class:`SimulatedCrash` inside the router's serve loop — the
router-death model for its checkpoint/resume contract.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch


class SimulatedCrash(RuntimeError):
    """Injected process death: the serve loop dies between dispatches,
    exactly like a SIGKILL'd host — no flush, no final checkpoint."""

    def __init__(self, round_: int):
        super().__init__(f"chaos: simulated crash at serving round "
                         f"{round_}")
        self.round = round_


def _nan_row(t: torch.Tensor, lane: int) -> torch.Tensor:
    out = t.clone()
    out[lane] = float("nan")
    return out


def poison_dataset(state, lane: int):
    """NaN-poison one lane's GP observation row (the whole padded ``y``
    row — any masked reduce over it goes non-finite, which is the point:
    the next fit on this lane must diverge, not limp)."""
    return dict(state, y=_nan_row(state["y"], lane))


def poison_theta(state, lane: int):
    """NaN-poison one lane's warm-start hyperparameter carry — the
    diverged-refit model for warm-path runs (cold fits never read the
    carry, so ``poison="data"`` is the cold-path fault)."""
    return dict(state, theta={k: _nan_row(v, lane)
                              for k, v in state["theta"].items()})


class FaultInjector:
    """Seed-deterministic fault schedule against a streaming engine.

    Rounds are 1-based serving-loop iterations (the engine's
    ``_round``); each configured entry fires at most once. The engine
    calls :meth:`inject` once per round (after its checkpoint, before
    pulling/admitting) and :meth:`on_dispatch` before each pool
    dispatch.
    """

    def __init__(self, seed: int = 0,
                 kill_at: Iterable[int] = (),
                 nan_poison_at: Iterable[int] = (),
                 drop_pool_at: Iterable[int] = (),
                 mute_pool_at: Iterable[int] = (),
                 delay_at: Iterable[int] = (),
                 storm_at: Iterable[int] = (),
                 flap_at: Iterable[int] = (),
                 slow_pool_at: Iterable[int] = (),
                 poison: str = "data",
                 delay_s: float = 0.05,
                 storm_n: int = 8,
                 flap_rounds: int = 2,
                 slow_s: float = 0.05,
                 slow_rounds: int = 3):
        if poison not in ("data", "theta"):
            raise ValueError(f"poison must be 'data' or 'theta', got "
                             f"{poison!r}")
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.kill_at = set(int(r) for r in kill_at)
        self.nan_poison_at = set(int(r) for r in nan_poison_at)
        self.drop_pool_at = set(int(r) for r in drop_pool_at)
        self.mute_pool_at = set(int(r) for r in mute_pool_at)
        self.delay_at = set(int(r) for r in delay_at)
        self.storm_at = set(int(r) for r in storm_at)
        self.flap_at = set(int(r) for r in flap_at)
        self.slow_pool_at = set(int(r) for r in slow_pool_at)
        self.poison = poison
        self.delay_s = float(delay_s)
        self.storm_n = int(storm_n)
        self.flap_rounds = int(flap_rounds)
        self.slow_s = float(slow_s)
        self.slow_rounds = int(slow_rounds)
        # live flap/slow state: (pool_id, expiry round) or None
        self._flapping: Optional[tuple] = None
        self._slow: Optional[tuple] = None
        self.events: list = []

    # -- helpers -------------------------------------------------------------
    def _log(self, kind: str, round_: int, **detail) -> dict:
        ev = dict(kind=kind, round=round_, **detail)
        self.events.append(ev)
        return ev

    def _pick_pool(self, pools, need_inflight: bool) -> Optional[int]:
        """Deterministically pick a target pool: alive, not muted, and
        (when the fault needs a victim request) holding in-flight work."""
        cands = [p.pool_id for p in pools
                 if not p.dead and not p.muted
                 and (not need_inflight or np.any(p.order >= 0))]
        if not cands:
            return None
        return int(cands[self.rng.integers(len(cands))])

    def _pick_lane(self, pool) -> Optional[int]:
        live = np.flatnonzero(
            (pool.order >= 0) & pool.state["active"].cpu().numpy())
        if live.size == 0:
            return None
        return int(live[self.rng.integers(live.size)])

    # -- engine hooks --------------------------------------------------------
    def inject(self, engine) -> None:
        """Fire every fault scheduled for the engine's current round.
        Called once per serving round; raises ``SimulatedCrash`` last so
        same-round poison/drop faults still land first."""
        r = engine._round
        pools = engine._pools
        # expire a live flap FIRST: the un-mute must land even if this
        # round fires new faults (including a new flap on another pool)
        if self._flapping is not None and r >= self._flapping[1]:
            pid = self._flapping[0]
            if pid < len(pools) and pools[pid].muted:
                pools[pid].muted = False
                self._log("unflap", r, pool=pid)
            self._flapping = None
        if r in self.storm_at:
            self.storm_at.discard(r)
            if engine.arrivals is None:
                self._log("storm_skipped", r)
            else:
                lo = engine._n_pulled
                hi = min(lo + self.storm_n, len(engine.arrivals))
                for i in range(lo, hi):
                    engine.arrivals[i] = 0.0
                self._log("storm", r, first=lo, n=hi - lo)
        if r in self.flap_at:
            self.flap_at.discard(r)
            pid = self._pick_pool(pools, need_inflight=False)
            if pid is None:
                self._log("flap_skipped", r)
            else:
                pools[pid].muted = True
                self._flapping = (pid, r + self.flap_rounds)
                self._log("flap", r, pool=pid,
                          until=r + self.flap_rounds)
        if r in self.slow_pool_at:
            self.slow_pool_at.discard(r)
            pid = self._pick_pool(pools, need_inflight=False)
            if pid is None:
                self._log("slow_pool_skipped", r)
            else:
                self._slow = (pid, r + self.slow_rounds)
                self._log("slow_pool", r, pool=pid,
                          until=r + self.slow_rounds,
                          slow_s=self.slow_s)
        if r in self.nan_poison_at:
            self.nan_poison_at.discard(r)
            pid = self._pick_pool(pools, need_inflight=True)
            lane = None if pid is None else self._pick_lane(pools[pid])
            if lane is None:
                self._log("nan_poison_skipped", r, pool=pid)
            else:
                p = pools[pid]
                fn = poison_dataset if self.poison == "data" else poison_theta
                p.state = fn(p.state, lane)
                self._log("nan_poison", r, pool=pid, lane=lane,
                          target=self.poison,
                          request=int(p.order[lane]))
        if r in self.drop_pool_at:
            self.drop_pool_at.discard(r)
            pid = self._pick_pool(pools, need_inflight=True)
            if pid is None:
                self._log("drop_pool_skipped", r)
            else:
                self._log("drop_pool", r, pool=pid,
                          requests=[int(i) for i in pools[pid].order
                                    if i >= 0])
                engine._drop_pool(pid, reason="chaos")
        if r in self.mute_pool_at:
            self.mute_pool_at.discard(r)
            pid = self._pick_pool(pools, need_inflight=True)
            if pid is None:
                self._log("mute_pool_skipped", r)
            else:
                pools[pid].muted = True
                self._log("mute_pool", r, pool=pid)
        if r in self.kill_at:
            self.kill_at.discard(r)
            self._log("kill", r)
            raise SimulatedCrash(r)

    def on_dispatch(self, engine, pool) -> None:
        """Pre-dispatch hook: inject the configured straggler delays —
        the one-shot ``delay_at`` and the persistent ``slow_pool_at``
        (every dispatch of the picked pool pays ``slow_s`` until the
        slow window expires; sleeps are not individually logged — the
        arming ``slow_pool`` event plus the round determine them)."""
        r = engine._round
        if r in self.delay_at:
            self.delay_at.discard(r)
            self._log("delay", r, pool=pool.pool_id,
                      delay_s=self.delay_s)
            time.sleep(self.delay_s)
        if self._slow is not None:
            pid, until = self._slow
            if r >= until:
                self._slow = None
            elif pool.pool_id == pid:
                time.sleep(self.slow_s)

    # -- artifacts -----------------------------------------------------------
    def save_events(self, path: str) -> None:
        """Dump the injected-fault event log as JSON — uploaded next to
        the arrival trace by the CI chaos job so a failing soak run
        replays with the exact same fault schedule."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(seed=self.seed, events=self.events), f,
                      sort_keys=True)


class NetworkChaos:
    """Seed-deterministic link-fault model for the fleet transport
    (``runtime/fleet.py`` ``SimTransport``).

    Per-message faults (drawn from one rng stream in send order, so the
    whole network history is determined by ``(seed, rates, schedule)``):

    * ``drop_rate`` — the message vanishes (logged, never delivered).
    * ``dup_rate`` — a second copy is delivered independently (the
      at-least-once dedup exercise).
    * ``delay_max`` — each copy waits an extra uniform 0..delay_max
      cycles before delivery.
    * ``reorder_rate`` — a cycle's ready-to-deliver batch for an
      endpoint is shuffled instead of kept in send order.

    Scheduled link events (fired by :meth:`step` when the transport's
    cycle clock reaches them):

    * ``partition_at`` — ``(cycle, src, dst)`` one-way cuts; ``"*"``
      wildcards either endpoint (so ``(c, "w0", "*")`` silences a host's
      egress while its ingress still works — the classic asymmetric
      partition).
    * ``heal_at`` — ``(cycle, src, dst)`` removes matching cuts;
      ``(cycle, "*", "*")`` heals everything.
    * ``kill_router_at`` — serve-loop cycles at which
      :meth:`maybe_kill` raises :class:`SimulatedCrash` (after the
      router's checkpoint, mirroring ``FaultInjector.kill_at``).

    Partitioned sends are logged as ``partition_drop`` events and count
    toward the transport's undelivered-envelope table — at-least-once
    retransmission above the transport is what recovers them.
    """

    def __init__(self, seed: int = 0,
                 drop_rate: float = 0.0,
                 dup_rate: float = 0.0,
                 reorder_rate: float = 0.0,
                 delay_max: int = 0,
                 partition_at: Iterable[tuple] = (),
                 heal_at: Iterable[tuple] = (),
                 kill_router_at: Iterable[int] = ()):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_rate = float(drop_rate)
        self.dup_rate = float(dup_rate)
        self.reorder_rate = float(reorder_rate)
        self.delay_max = int(delay_max)
        self.partition_at = sorted((int(c), str(s), str(d))
                                   for c, s, d in partition_at)
        self.heal_at = sorted((int(c), str(s), str(d))
                              for c, s, d in heal_at)
        self.kill_router_at = set(int(c) for c in kill_router_at)
        self.cuts: set = set()          # live one-way (src, dst) cuts
        self.events: list = []

    def _log(self, kind: str, cycle: int, **detail) -> dict:
        ev = dict(kind=kind, cycle=cycle, **detail)
        self.events.append(ev)
        return ev

    # -- schedule ------------------------------------------------------------
    def step(self, cycle: int) -> None:
        """Apply every partition/heal whose cycle has arrived (``<=`` so
        a transport that skips cycles still converges to the scheduled
        link state)."""
        while self.partition_at and self.partition_at[0][0] <= cycle:
            c, s, d = self.partition_at.pop(0)
            self.cuts.add((s, d))
            self._log("partition", cycle, src=s, dst=d, scheduled=c)
        while self.heal_at and self.heal_at[0][0] <= cycle:
            c, s, d = self.heal_at.pop(0)
            if (s, d) == ("*", "*"):
                healed = sorted(self.cuts)
                self.cuts.clear()
            else:
                healed = sorted(cut for cut in self.cuts
                                if cut == (s, d))
                self.cuts -= set(healed)
            self._log("heal", cycle, src=s, dst=d, scheduled=c,
                      healed=[list(h) for h in healed])

    def blocked(self, src: str, dst: str) -> bool:
        """Is the one-way ``src -> dst`` link currently cut?"""
        return any((cs in ("*", src)) and (cd in ("*", dst))
                   for cs, cd in self.cuts)

    # -- per-message fate ----------------------------------------------------
    def fate(self, cycle: int, src: str, dst: str, seq: int) -> list:
        """Delivery fate of one send: a list of extra delays (in cycles),
        one per delivered copy — ``[]`` means dropped, ``[0]`` is clean
        delivery, ``[2, 0]`` is a delayed original plus a prompt
        duplicate. Exactly three rng draws per call regardless of
        outcome, so the stream stays aligned across replays."""
        u_drop = self.rng.random()
        u_dup = self.rng.random()
        delays = self.rng.integers(0, self.delay_max + 1, size=2)
        if u_drop < self.drop_rate:
            self._log("drop", cycle, src=src, dst=dst, seq=seq)
            return []
        copies = [int(delays[0])]
        if u_dup < self.dup_rate:
            copies.append(int(delays[1]))
            self._log("duplicate", cycle, src=src, dst=dst, seq=seq)
        return copies

    def deliver_order(self, cycle: int, endpoint: str, k: int):
        """Delivery order for an endpoint's k ready messages this cycle:
        a permutation when the reorder fault fires, else None (keep
        arrival order). One rng draw always; the permutation draw only
        when it fires."""
        if k > 1 and self.rng.random() < self.reorder_rate:
            self._log("reorder", cycle, endpoint=endpoint, n=k)
            return self.rng.permutation(k)
        return None

    def maybe_kill(self, cycle: int) -> None:
        """Raise :class:`SimulatedCrash` if a router kill is scheduled
        for this serve-loop cycle (one-shot, like ``kill_at``)."""
        if cycle in self.kill_router_at:
            self.kill_router_at.discard(cycle)
            self._log("kill_router", cycle)
            raise SimulatedCrash(cycle)

    # -- artifacts -----------------------------------------------------------
    def save_events(self, path: str) -> None:
        """JSON event log, same artifact contract as
        :meth:`FaultInjector.save_events`."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(seed=self.seed, events=self.events), f,
                      sort_keys=True)


def load_events(path: str) -> dict:
    """Round-trip of :meth:`FaultInjector.save_events`: the
    ``{seed, events}`` dict as saved — the replay side of the CI
    artifact contract (re-seed a fresh ``FaultInjector`` with ``seed``
    and the failing schedule, and the event log reproduces)."""
    with open(path) as f:
        return json.load(f)
