"""Fault tolerance and elasticity, the port's own copy of
``repro/distributed/fault_tolerance.py`` (host code, no device work):

  * ``HeartbeatMonitor`` — liveness and straggler tracking (the
    streaming server's lane pools, the fleet);
  * ``elastic_assignment`` — the deterministic, stateless (step, alive
    hosts) -> data shard map;
  * ``TrainController`` — checkpoint every k steps, auto-resume,
    SIGTERM-safe shutdown and a failure-injection hook; the crash path
    saves the last completed step, once. Over a mesh, ``agree`` makes
    every rank stop after the same step (a SIGTERM reaches the ranks at
    different times, and a save is a collective).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class HeartbeatMonitor:
    """Liveness/straggler tracker.

    Timestamps come from ``clock`` — ``time.monotonic`` by default. Wall
    clocks (``time.time``) are wrong here: an NTP step or operator
    ``date`` call jumps ``now`` past ``dead_timeout_s`` and falsely
    flags every host dead at once. Callers that need deterministic
    timelines (tests, the simulated fleet transport) inject their own
    clock instead of passing explicit ``now=`` everywhere.
    """

    def __init__(self, n_hosts: int, window: int = 20,
                 straggler_sigma: float = 3.0, dead_timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n_hosts = n_hosts
        self.window = window
        self.sigma = straggler_sigma
        self.dead_timeout_s = dead_timeout_s
        self.clock = clock
        self.step_times: Dict[int, List[float]] = {h: [] for h in range(n_hosts)}
        self.last_seen: Dict[int, float] = {h: self.clock() for h in range(n_hosts)}

    def report(self, host: int, step_time_s: float, now: Optional[float] = None):
        ts = self.step_times[host]
        ts.append(step_time_s)
        if len(ts) > self.window:
            ts.pop(0)
        self.last_seen[host] = now if now is not None else self.clock()

    def heartbeat(self, host: int, now: Optional[float] = None):
        """Liveness-only ping: refresh ``last_seen`` without recording a
        step time. A host that is alive but between steps (the streaming
        engine's round-top ping) must not pollute its trailing
        step-time window with zeros — that would mask it from
        :meth:`stragglers`, whose whole point is catching alive-but-slow
        hosts."""
        self.last_seen[host] = now if now is not None else self.clock()

    def _silent(self, now: Optional[float]) -> set:
        now = now if now is not None else self.clock()
        return {h for h, t in self.last_seen.items()
                if now - t > self.dead_timeout_s}

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        """Hosts whose trailing-median step time sits k-MAD over the
        fleet median. Hosts already past the dead timeout are EXCLUDED
        from both the population and the report: a dead host's stale
        trailing median would otherwise drag the MAD threshold up and
        mask true (alive-but-slow) stragglers."""
        dead = self._silent(now)
        meds = {h: np.median(ts) for h, ts in self.step_times.items()
                if ts and h not in dead}
        if len(meds) < 2:
            return []
        vals = np.array(list(meds.values()))
        med, mad = np.median(vals), np.median(np.abs(vals - np.median(vals)))
        thresh = med + self.sigma * max(mad, 1e-6) * 1.4826
        return [h for h, v in meds.items() if v > thresh]

    def dead(self, now: Optional[float] = None) -> List[int]:
        """Hosts silent past the hard timeout. Flagged hosts have their
        ``step_times`` pruned: their samples are stale by definition, and
        a host that later rejoins must rebuild its trailing window from
        fresh reports instead of resurrecting pre-failure timings."""
        out = sorted(self._silent(now))
        for h in out:
            self.step_times[h] = []
        return out


# ---------------------------------------------------------------------------
# elastic data assignment
# ---------------------------------------------------------------------------


def elastic_assignment(step: int, alive_hosts: List[int],
                       global_batch: int) -> Dict[int, tuple]:
    """Deterministic (step, alive-set) -> {host: (offset, size)} split of
    the global batch. Pure function of its inputs: every host computes the
    same map with no coordination; when a host dies, the next step's map
    redistributes its share."""
    alive = sorted(alive_hosts)
    n = len(alive)
    base = global_batch // n
    rem = global_batch % n
    out, off = {}, 0
    # rotate the remainder so the extra sample load round-robins over steps
    for i, h in enumerate(alive):
        size = base + (1 if (i + step) % n < rem else 0)
        out[h] = (off, size)
        off += size
    return out


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainController:
    """Preemption-safe training driver around a step function."""
    step_fn: Callable                      # (state, batch) -> (state, metrics)
    batch_fn: Callable                     # (step) -> batch
    ckpt_manager: "object"                 # checkpoint.CheckpointManager
    max_steps: int = 1000
    failure_injector: Optional[Callable] = None  # (step) -> None | raises
    # (this rank's stop flag) -> whether any rank stops
    agree: Optional[Callable] = None

    def run(self, state, start_step: int = 0, install_sigterm: bool = True):
        self._stop = False

        def on_term(signum, frame):
            self._stop = True

        prev = None
        if install_sigterm:
            prev = signal.signal(signal.SIGTERM, on_term)
        metrics = None
        step, saved, stop = start_step, None, False
        try:
            while step < self.max_steps and not stop:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                state, metrics = self.step_fn(state, self.batch_fn(step))
                step += 1
                if self.ckpt_manager.maybe_save(step, state):
                    saved = step
                stop = (self._stop if self.agree is None
                        else self.agree(self._stop))
        finally:
            # preemption / crash path: persist the last completed step
            if saved != step:
                self.ckpt_manager.maybe_save(step, state, force=True)
            self.ckpt_manager.wait()
            if install_sigterm and prev is not None:
                signal.signal(signal.SIGTERM, prev)
        return state, step, metrics
