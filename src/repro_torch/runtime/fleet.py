"""Fleet front end: fault-tolerant multi-host request transport.
Counterpart of ``repro/runtime/fleet.py``.

One router process owns the arrival feed and the emission watermark; N
worker hosts each run a ``StreamingBayesSplitEdge`` pool group and never
see the feed — they serve whatever request envelopes reach them. The
pieces:

* :class:`Envelope` — the wire unit. Every ``(src, dst)`` link numbers
  its envelopes monotonically; receivers run :class:`_LinkDedup` (a
  watermark + sparse seen-set) so duplicated or reordered deliveries
  collapse to exactly-once *processing* per envelope.
* :class:`Transport` — the pluggable delivery interface (``send`` /
  ``recv`` / ``tick`` / ``now``). :class:`SimTransport` is the
  deterministic in-process implementation: a synchronous-cycle message
  pass (the pyDcop computation pattern — every cycle delivers last
  cycle's sends) whose fault model is a seeded
  ``runtime.chaos.NetworkChaos`` (drop / duplicate / reorder / bounded
  delay / one-way partition / heal), so every network failure is
  replayable on a 2-core CI box. :class:`SocketTransport` is the thin
  real-network adapter behind the same interface (length-prefixed
  pickled envelopes over TCP).
* :class:`FleetWorker` — wraps a streaming engine fed exclusively by
  request envelopes. Idempotent by construction: a duplicate REQ for an
  in-flight request is ignored, one for a completed request re-sends
  the cached result. Results are sent at-least-once — retransmitted
  with exponential backoff until the router's ACK arrives — and a
  partitioned-off worker keeps draining its admitted work locally,
  reconciling (result retransmission + dedup) on heal.
* :class:`FleetRouter` — pulls the feed, places requests on healthy
  workers (free-capacity scoring with round-robin tie-break, the
  streaming engine's placement shape), and gathers results.
  Robustness ladder: per-request retry with exponential timeout
  backoff and a retry budget (``max_attempts``); per-worker strikes on
  timeout (doubling backoff, then drop + requeue — the streaming
  engine's strike ladder applied across hosts); worker-loss detection
  through ``HeartbeatMonitor`` (armed with the transport clock, so
  simulated time drives it deterministically); hopeless requests emit
  degraded results (reason ``"undeliverable"``), never silence. Every
  admitted request emits exactly one result after ``dedup_results``.

Replay contract: workers admit through the exact same staging path as
the single-process engine (``stage_scenario`` → ``admit_init`` /
``admit_lanes``), and a lane's trajectory is a function of its own
request only — so a zero-fault fleet run is *bitwise* the single-host
streaming run (cold path), and re-dispatched duplicates produce
identical payloads (first-result-wins dedup is therefore
deterministic too).

Router resume contract: with ``ckpt_dir``/``ckpt_every`` armed the
router snapshots its watermark (emitted set), queue, in-flight table
and per-link sequence counters at the top of every k-th cycle —
*before* any emission that cycle — via ``checkpoint/ckpt.py``'s atomic
commits. ``FleetRouter.resume`` rebuilds from the latest commit and
replays the feed prefix; with ``ckpt_every=1`` a killed-then-resumed
router never double-emits (the merged stream needs no dedup), and with
sparser snapshots ``dedup_results`` restores exactly-once. The
snapshot keeps the reference's keys and dtypes, so a router checkpoint
written by either package resumes in the other.

Devices: each :class:`FleetWorker`'s streaming engine runs on ``device``,
the card unless the caller asks for the CPU (``device="cpu"``); without
CUDA the default raises. The router and the transports are host code.
Envelopes carry host data only — a result's ``BOResult`` and ledger row
are numpy after the engine's collect, and a worker refuses to send one
that holds a tensor — so :class:`SocketTransport` pickles them whatever
the workers' device.
"""
from __future__ import annotations

import dataclasses
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

import torch

from repro_torch.checkpoint import ckpt as ckptlib
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.distributed.sharding import next_admission_shard
from repro_torch.runtime.stream import (Scenario, StreamingBayesSplitEdge,
                                        StreamResult, dedup_results,
                                        host_degraded_result)

ROUTER = "router"

ENVELOPE_KINDS = ("req", "result", "ack", "hb", "stop")


@dataclasses.dataclass
class Envelope:
    """One transport message. ``seq`` is monotonic per ``(src, dst)``
    link (assigned by the sender), the receiver's dedup key. ``index``
    is the arrival index the message is about (-1 for link-level
    messages: heartbeats, stop)."""
    seq: int
    src: str
    dst: str
    kind: str          # one of ENVELOPE_KINDS
    index: int = -1
    payload: object = None

    def brief(self) -> dict:
        """JSON-able row for event logs / the undelivered table (the
        envelope kind travels as ``msg`` — ``kind`` is the event-log
        row's own discriminator)."""
        return dict(seq=self.seq, src=self.src, dst=self.dst,
                    msg=self.kind, index=self.index)


class _LinkDedup:
    """Exactly-once processing over an at-least-once link: a contiguous
    watermark ``lo`` (every seq below it was seen) plus the sparse set
    of out-of-order seqs above it — O(reorder window) memory however
    long the link lives."""

    def __init__(self):
        self.lo = 0
        self.seen: set = set()

    def fresh(self, seq: int) -> bool:
        if seq < self.lo or seq in self.seen:
            return False
        self.seen.add(seq)
        while self.lo in self.seen:
            self.seen.discard(self.lo)
            self.lo += 1
        return True


class Transport:
    """Pluggable delivery. Implementations may drop, duplicate,
    reorder or delay envelopes arbitrarily — every layer above assumes
    at-least-once + dedup, nothing more."""

    def send(self, env: Envelope) -> None:
        raise NotImplementedError

    def recv(self, endpoint: str) -> List[Envelope]:
        """Drain every envelope currently deliverable to ``endpoint``."""
        raise NotImplementedError

    def tick(self) -> None:
        """Advance one delivery cycle (simulated transports); no-op on
        real networks."""

    def now(self) -> float:
        """The transport's clock: cycle count (simulated) or monotonic
        seconds (real). All fleet timeouts are in these units."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SimTransport(Transport):
    """Deterministic in-process transport: a synchronous message cycle.
    ``send`` enqueues for delivery at the *next* ``tick`` (plus any
    chaos delay); ``recv`` drains an endpoint's ready queue. With no
    ``chaos`` attached delivery is lossless FIFO — the zero-fault
    baseline — and every fault is a seeded ``NetworkChaos`` decision,
    so a whole network history replays from ``(chaos seed, schedule)``.
    """

    def __init__(self, endpoints: Sequence[str], chaos=None):
        self.endpoints = list(endpoints)
        self.chaos = chaos
        self.cycle = 0
        self._ready: Dict[str, deque] = {e: deque() for e in self.endpoints}
        self._inflight: list = []     # [deliver_cycle, fifo_order, env]
        self._order = 0
        self.dropped: list = []       # envelopes that will never deliver
        self.stats = dict(sent=0, delivered=0, dropped=0,
                          partition_dropped=0, duplicated=0)

    def send(self, env: Envelope) -> None:
        if env.dst not in self._ready:
            raise KeyError(f"unknown endpoint {env.dst!r}")
        self.stats["sent"] += 1
        ch = self.chaos
        if ch is not None and ch.blocked(env.src, env.dst):
            ch._log("partition_drop", self.cycle, **env.brief())
            self.stats["partition_dropped"] += 1
            self.dropped.append(env)
            return
        fates = [0] if ch is None else ch.fate(self.cycle, env.src,
                                               env.dst, env.seq)
        if not fates:
            self.stats["dropped"] += 1
            self.dropped.append(env)
            return
        if len(fates) > 1:
            self.stats["duplicated"] += len(fates) - 1
        for extra in fates:
            self._inflight.append(
                [self.cycle + 1 + int(extra), self._order, env])
            self._order += 1

    def tick(self) -> None:
        self.cycle += 1
        ch = self.chaos
        if ch is not None:
            ch.step(self.cycle)
        due = [rec for rec in self._inflight if rec[0] <= self.cycle]
        if not due:
            return
        self._inflight = [rec for rec in self._inflight
                          if rec[0] > self.cycle]
        due.sort(key=lambda rec: (rec[0], rec[1]))
        by_ep: Dict[str, list] = {}
        for _, _, env in due:
            by_ep.setdefault(env.dst, []).append(env)
        for ep in sorted(by_ep):
            envs = by_ep[ep]
            # a partition cut while the message was in flight blocks
            # delivery too — the cut is airtight until healed
            if ch is not None:
                passed = []
                for env in envs:
                    if ch.blocked(env.src, env.dst):
                        ch._log("partition_drop", self.cycle,
                                **env.brief())
                        self.stats["partition_dropped"] += 1
                        self.dropped.append(env)
                    else:
                        passed.append(env)
                envs = passed
                if len(envs) > 1:
                    perm = ch.deliver_order(self.cycle, ep, len(envs))
                    if perm is not None:
                        envs = [envs[int(i)] for i in perm]
            self._ready[ep].extend(envs)
            self.stats["delivered"] += len(envs)

    def recv(self, endpoint: str) -> List[Envelope]:
        q = self._ready[endpoint]
        out = list(q)
        q.clear()
        return out

    def now(self) -> float:
        return float(self.cycle)

    def undelivered_table(self) -> List[dict]:
        """Every envelope the transport lost or still holds — the CI
        artifact a failing chaos soak uploads next to the event log."""
        rows = [dict(fate="lost", **e.brief()) for e in self.dropped]
        rows += [dict(fate="in_flight", deliver_cycle=int(c), **e.brief())
                 for c, _, e in self._inflight]
        for ep, q in self._ready.items():
            rows += [dict(fate="unconsumed", **e.brief()) for e in q]
        return rows


class SocketTransport(Transport):
    """Thin real-network adapter: length-prefixed pickled envelopes
    over TCP, one listening socket per endpoint, lazily-opened cached
    peer connections, reader threads draining into a thread-safe inbox.
    ``tick`` is a no-op and ``now`` is wall-monotonic — the fleet's
    timeout/backoff logic is identical under both transports, only the
    clock units change (cycles vs seconds).

    For real multi-host runs give process 0 the router endpoint and
    process ``i`` worker endpoint ``w{i-1}``, with ``peers`` mapping each
    endpoint name to its ``(host, port)``. Connection failures are
    treated as drops — the at-least-once retransmission above recovers
    once the peer returns. ``device`` is where a :class:`FleetWorker`
    built on this transport runs by default (``socket_fleet`` sets it).
    """

    def __init__(self, name: str, peers: Dict[str, tuple],
                 bind: tuple = ("127.0.0.1", 0), device=None):
        self.name = name
        self.peers = dict(peers)
        self.device = None if device is None else resolve_device(device)
        self._lock = threading.Lock()
        self._inbox: deque = deque()
        self._conns: Dict[str, socket.socket] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(bind)
        self._listener.listen(16)
        self.addr = self._listener.getsockname()
        self._closing = False
        self._threads: list = []
        th = threading.Thread(target=self._accept_loop, daemon=True)
        th.start()
        self._threads.append(th)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            th = threading.Thread(target=self._read_loop, args=(conn,),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closing:
                hdr = self._read_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack("!I", hdr)
                body = self._read_exact(conn, n)
                if body is None:
                    return
                env = pickle.loads(body)
                with self._lock:
                    self._inbox.append(env)
        except OSError:
            return

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def send(self, env: Envelope) -> None:
        body = pickle.dumps(env)
        msg = struct.pack("!I", len(body)) + body
        try:
            conn = self._conns.get(env.dst)
            if conn is None:
                conn = socket.create_connection(self.peers[env.dst],
                                                timeout=5.0)
                self._conns[env.dst] = conn
            conn.sendall(msg)
        except OSError:
            # an unreachable peer is a dropped envelope: the
            # retransmission layers above recover when it returns
            self._conns.pop(env.dst, None)

    def recv(self, endpoint: str) -> List[Envelope]:
        if endpoint != self.name:
            raise ValueError(f"endpoint {endpoint!r} is not this "
                             f"transport's ({self.name!r})")
        with self._lock:
            out = list(self._inbox)
            self._inbox.clear()
        return out

    def now(self) -> float:
        return time.monotonic()

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()


def socket_fleet(n_workers: int, device="cuda") -> tuple:
    """Loopback socket fleet for smoke tests: returns
    ``(router_transport, [worker transports])`` with every endpoint
    bound to an ephemeral 127.0.0.1 port and all peer tables wired.
    Each worker transport carries ``device`` (the card unless the caller
    asks for the CPU; without CUDA the default raises), where a
    :class:`FleetWorker` built on it runs."""
    dev = resolve_device(device)
    names = [ROUTER] + [f"w{i}" for i in range(n_workers)]
    transports = {n: SocketTransport(n, {}, device=None if n == ROUTER
                                     else dev)
                  for n in names}
    addrs = {n: t.addr for n, t in transports.items()}
    for t in transports.values():
        t.peers.update(addrs)
    return transports[ROUTER], [transports[n] for n in names[1:]]


def _check_host(obj, where: str) -> None:
    """Raise if ``obj`` (a result payload: dataclasses, dicts, lists,
    numpy and Python scalars) holds a torch tensor — envelopes carry
    host data only, so a transport can pickle them."""
    if isinstance(obj, torch.Tensor):
        raise TypeError(f"{where} holds a torch tensor on "
                        f"{obj.device}: envelopes carry host data only")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _check_host(getattr(obj, f.name), f"{where}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _check_host(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_host(v, f"{where}[{i}]")


class FleetWorker:
    """One worker host: a ``StreamingBayesSplitEdge`` pool group fed by
    request envelopes instead of a local feed. Engine kwargs
    (``config``, ``n_lanes``, quarantine knobs, ...) pass through —
    ``l_pad``/``budget_max`` are required because an envelope feed has
    no length to derive the static shapes from. ``device`` is where the
    engine runs: by default the transport's ``device`` where it has one
    (``socket_fleet``), else the card."""

    def __init__(self, name: str, transport: Transport, config=None, *,
                 l_pad: int, budget_max: int, n_lanes: int = 4,
                 router: str = ROUTER, resend_after: float = 6.0,
                 device=None, **kw):
        self.name = name
        self.transport = transport
        self.router = router
        self.resend_after = float(resend_after)
        if device is None:
            device = getattr(transport, "device", None) or "cuda"
        self.eng = StreamingBayesSplitEdge(
            [], config, n_lanes=n_lanes, l_pad=l_pad,
            budget_max=budget_max, device=device, **kw)
        self._links: Dict[str, _LinkDedup] = {}
        self._seq: Dict[str, int] = {}
        self._done: Dict[int, StreamResult] = {}   # result cache (idempotent REQ)
        self._unacked: Dict[int, list] = {}        # idx -> [res, sent_at, sends]
        self._stopped = False
        self.counters = dict(n_reqs=0, n_dup_envelopes=0, n_dup_reqs=0,
                             n_results=0, n_resends=0, n_dispatches=0)

    # -- wire helpers --------------------------------------------------------
    def _send(self, dst: str, kind: str, index: int = -1,
              payload=None) -> None:
        seq = self._seq.get(dst, 0)
        self._seq[dst] = seq + 1
        self.transport.send(Envelope(seq=seq, src=self.name, dst=dst,
                                     kind=kind, index=index,
                                     payload=payload))

    def _push_result(self, res: StreamResult) -> None:
        now = self.transport.now()
        rec = self._unacked.setdefault(res.index, [res, now, 0])
        rec[1], rec[2] = now, rec[2] + 1
        self._send(self.router, "result", index=res.index, payload=res)

    # -- one serving step ----------------------------------------------------
    def step(self) -> int:
        """One envelope-driven serving round: drain the inbox, admit,
        dispatch, collect, send/retransmit results, heartbeat. Returns
        the number of results produced this step."""
        eng, t = self.eng, self.transport
        for env in t.recv(self.name):
            link = self._links.setdefault(env.src, _LinkDedup())
            if not link.fresh(env.seq):
                self.counters["n_dup_envelopes"] += 1
                continue
            if env.kind == "req":
                idx = env.index
                if idx in self._done:
                    # duplicate of a completed request: idempotent —
                    # answer from the cache, never re-execute
                    self.counters["n_dup_reqs"] += 1
                    self._push_result(self._done[idx])
                elif idx in eng._requests:
                    self.counters["n_dup_reqs"] += 1
                else:
                    self.counters["n_reqs"] += 1
                    eng._requests[idx] = env.payload
                    eng._pending.append((idx, env.payload))
            elif env.kind == "ack":
                self._unacked.pop(env.index, None)
            elif env.kind == "stop":
                self._stopped = True
        pending = eng._pending
        for p in eng._pools:
            k = min(p.free_count(), len(pending))
            if k:
                p.admit([pending.popleft() for _ in range(k)])
        out: list = []

        def drain(pool):
            flushed, faulted, _ = pool.collect()
            out.extend(flushed)
            for lane in faulted:
                eng._handle_fault(pool, lane, pending)

        c = eng._counters
        for p in eng._pools:
            drain(p)                      # budget<=n_init / retired lanes
            if p.live_count() > 0:
                entry = p.dispatch(draining=not pending)
                if entry is not None:
                    # the engine's own accounting of a dispatch: its
                    # acquisition iterations and the LANE_WIDTH chunks
                    # they computed (one posterior launch each on the
                    # card)
                    self.counters["n_dispatches"] += 1
                    c["acq_iters"] += entry["acq_iters"]
                    c["acq_chunks"] += entry["acq_iters"] * entry["chunks"]
                drain(p)
        for res in out:
            _check_host(res.result, "result")
            _check_host(res.raw, "raw")
            self.counters["n_results"] += 1
            self._done[res.index] = res
            self._push_result(res)
        now = t.now()
        for idx, rec in list(self._unacked.items()):
            res, sent_at, sends = rec
            if now - sent_at >= self.resend_after * (2 ** (sends - 1)):
                self.counters["n_resends"] += 1
                self._push_result(res)
        self._send(self.router, "hb",
                   payload=dict(free=sum(p.free_count()
                                         for p in eng._pools)))
        return len(out)

    def run_loop(self, poll_s: float = 0.005) -> None:
        """Socket-mode driver: step until a ``stop`` envelope arrives."""
        while not self._stopped:
            if self.step() == 0:
                time.sleep(poll_s)


class FleetRouter:
    """The feed owner: places requests on workers, gathers results,
    survives every network failure the chaos model can throw.

    ``workers`` may be :class:`FleetWorker` objects (simulated fleets:
    the router drives their ``step`` every cycle, after ``tick``) or
    bare endpoint names with a ``capacity`` map (socket fleets: the
    workers run their own loops).

    Timeouts/backoffs are in transport-clock units (cycles under
    ``SimTransport``, seconds under ``SocketTransport``).
    """

    def __init__(self, requests: Iterable[Scenario],
                 transport: Transport,
                 workers: Sequence, *,
                 capacity: Optional[Dict[str, int]] = None,
                 l_pad: Optional[int] = None,
                 budget_max: Optional[int] = None,
                 arrivals: Optional[Sequence[float]] = None,
                 dt_s: float = 1.0,
                 request_timeout: float = 48.0,
                 max_attempts: int = 4,
                 worker_backoff: float = 8.0,
                 worker_max_strikes: int = 3,
                 hb_timeout: Optional[float] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: int = 3,
                 chaos=None,
                 on_result: Optional[Callable[[StreamResult], None]] = None,
                 max_cycles: int = 100_000, poll_s: float = 0.005):
        self.transport = transport
        if workers and isinstance(workers[0], FleetWorker):
            self._drive: List[FleetWorker] = list(workers)
            self.worker_names = [w.name for w in self._drive]
            self.capacity = {w.name: w.eng.n_lanes for w in self._drive}
        else:
            self._drive = []
            self.worker_names = [str(w) for w in workers]
            if capacity is None:
                raise ValueError("name-only workers need a capacity map")
            self.capacity = {n: int(capacity[n]) for n in self.worker_names}
        if not self.worker_names:
            raise ValueError("a fleet needs at least one worker")
        self._widx = {n: i for i, n in enumerate(self.worker_names)}
        self._feed = iter(requests)
        self._feed_len = (len(requests)
                          if hasattr(requests, "__len__") else None)
        self.l_pad = l_pad
        self.budget_max = budget_max
        self.arrivals = (None if arrivals is None
                         else [float(t) for t in arrivals])
        self.dt_s = float(dt_s)
        self.request_timeout = float(request_timeout)
        self.max_attempts = int(max_attempts)
        self.worker_backoff = float(worker_backoff)
        self.worker_max_strikes = int(worker_max_strikes)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.ckpt_keep = int(ckpt_keep)
        if ckpt_every and not ckpt_dir:
            raise ValueError("ckpt_every needs a ckpt_dir")
        self.chaos = chaos
        self.on_result = on_result
        self.max_cycles = int(max_cycles)
        self.poll_s = float(poll_s)
        self.monitor = (None if hb_timeout is None else
                        HeartbeatMonitor(len(self.worker_names),
                                         dead_timeout_s=float(hb_timeout),
                                         clock=transport.now))
        self._seq: Dict[str, int] = {}
        self._links: Dict[str, _LinkDedup] = {}
        self._pending: deque = deque()      # (idx, Scenario)
        self._requests: Dict[int, Scenario] = {}
        self._inflight: Dict[int, dict] = {}  # idx -> worker/sent_at/attempts
        self._attempts: Dict[int, int] = {}   # idx -> dispatches so far
        self._emitted: set = set()
        self._dead: set = set()             # worker names declared lost
        self._strikes: Dict[str, int] = {n: 0 for n in self.worker_names}
        self._backoff_until: Dict[str, float] = {n: 0.0
                                                 for n in self.worker_names}
        self._n_pulled = 0
        self._feed_done = False
        self._served = False
        self._cycle = 0
        self._rr = 0
        self._elapsed0 = 0.0                # resume offset (clock units)
        self._t0: Optional[float] = None
        self._restore: Optional[dict] = None
        self._stats: dict = {}
        self._counters = dict(
            n_results=0, n_degraded=0, n_rejected=0, n_undeliverable=0,
            n_retries=0, n_timeouts=0, n_worker_strikes=0,
            n_worker_dead=0, n_worker_rejoined=0, n_dup_results=0,
            n_checkpoints=0, deadline_total=0, deadline_hits=0)

    # -- clocks --------------------------------------------------------------
    def _now(self) -> float:
        return self.transport.now() - self._t0 + self._elapsed0

    def _now_trace(self, now: float) -> float:
        return now * self.dt_s

    # -- wire helpers --------------------------------------------------------
    def _send(self, dst: str, kind: str, index: int = -1,
              payload=None) -> None:
        seq = self._seq.get(dst, 0)
        self._seq[dst] = seq + 1
        self.transport.send(Envelope(seq=seq, src=ROUTER, dst=dst,
                                     kind=kind, index=index,
                                     payload=payload))

    # -- feed ----------------------------------------------------------------
    def _oversized(self, sc: Scenario) -> bool:
        return ((self.budget_max is not None
                 and sc.budget > self.budget_max)
                or (self.l_pad is not None
                    and sc.problem.L > self.l_pad))

    def _arrived(self, i: int, now: float) -> bool:
        if self.arrivals is None or i >= len(self.arrivals):
            return True
        return self.arrivals[i] <= self._now_trace(now)

    def _pull(self, now: float) -> Iterator[StreamResult]:
        """Move arrived requests into the queue; oversized ones emit an
        immediate degraded rejection (a live feed is never pre-screened)."""
        if self._feed_done:
            return
        total_cap = sum(self.capacity.values())
        while True:
            if (self.arrivals is None
                    and len(self._pending) + len(self._inflight)
                    >= 2 * total_cap):
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
            if self._oversized(sc):
                self._counters["n_rejected"] += 1
                yield self._degrade(i, sc, now, "rejected")
                continue
            self._requests[i] = sc
            self._pending.append((i, sc))

    def _degrade(self, idx: int, sc: Scenario, now: float,
                 reason: str) -> StreamResult:
        self._requests.pop(idx, None)
        self._inflight.pop(idx, None)
        self._attempts.pop(idx, None)
        return host_degraded_result(idx, sc, self._now_trace(now), reason)

    # -- worker health -------------------------------------------------------
    def _alive(self, name: str) -> bool:
        return name not in self._dead

    def _strike(self, name: str, now: float) -> None:
        """One timeout strike: doubling backoff, then drop the worker
        (its in-flight work requeues) — the streaming engine's ladder
        across hosts."""
        self._counters["n_worker_strikes"] += 1
        s = self._strikes[name] = self._strikes[name] + 1
        self._backoff_until[name] = (
            now + self.worker_backoff * (2 ** (s - 1)))
        if s > self.worker_max_strikes:
            self._drop_worker(name)

    def _drop_worker(self, name: str) -> None:
        if name in self._dead:
            return
        self._dead.add(name)
        self._counters["n_worker_dead"] += 1
        for idx in sorted(i for i, rec in self._inflight.items()
                          if rec["worker"] == name):
            rec = self._inflight.pop(idx)
            self._pending.append((idx, self._requests[idx]))
            self._counters["n_retries"] += 1

    def _rejoin(self, name: str) -> None:
        if name in self._dead:
            self._dead.discard(name)
            self._counters["n_worker_rejoined"] += 1
        self._strikes[name] = 0
        self._backoff_until[name] = 0.0

    # -- checkpoint / resume -------------------------------------------------
    def _meta(self) -> dict:
        return dict(kind="fleet-router",
                    workers=list(self.worker_names),
                    capacity=[self.capacity[n] for n in self.worker_names],
                    dt_s=self.dt_s, cycle=self._cycle)

    def _ckpt_tree(self) -> dict:
        inf = sorted(self._inflight)
        att = sorted(self._attempts)
        names = sorted(self._seq)
        return dict(
            pending=np.asarray([i for i, _ in self._pending], np.int64),
            inflight_idx=np.asarray(inf, np.int64),
            inflight_worker=np.asarray(
                [self._widx[self._inflight[i]["worker"]] for i in inf],
                np.int64),
            attempts_idx=np.asarray(att, np.int64),
            attempts_n=np.asarray([self._attempts[i] for i in att],
                                  np.int64),
            emitted=np.asarray(sorted(self._emitted), np.int64),
            n_pulled=np.int64(self._n_pulled),
            rr=np.int64(self._rr),
            elapsed=np.float64(self._now()),
            seq_names=np.asarray([self._widx.get(n, -1) for n in names],
                                 np.int64),
            seq_vals=np.asarray([self._seq[n] for n in names], np.int64))

    def checkpoint_now(self) -> int:
        if not self.ckpt_dir:
            raise ValueError("no ckpt_dir configured")
        ckptlib.save(self.ckpt_dir, self._cycle, self._ckpt_tree(),
                     metadata=dict(fleet=self._meta()), blocking=True)
        self._counters["n_checkpoints"] += 1
        self._gc_ckpts()
        return self._cycle

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
                and self._cycle % self.ckpt_every == 0):
            self.checkpoint_now()

    @classmethod
    def resume(cls, ckpt_dir: str, requests: Iterable[Scenario],
               transport: Transport, workers: Sequence,
               step: Optional[int] = None, **kw) -> "FleetRouter":
        """Rebuild a router from its latest committed snapshot.
        ``requests`` must replay the same feed; in-flight requests move
        back to the queue (their workers died with the old process —
        re-dispatch re-executes them, and execution is deterministic,
        so the merged result stream still replay-matches). The emitted
        watermark rides the snapshot: everything emitted before it
        never re-emits."""
        if step is None:
            step = ckptlib.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {ckpt_dir}")
        man = ckptlib.load_manifest(ckpt_dir, step)
        meta = man.get("metadata", {}).get("fleet")
        if meta is None:
            raise ValueError(f"{ckpt_dir} step {step} is not a "
                             f"fleet-router checkpoint")
        kw.setdefault("dt_s", meta["dt_s"])
        kw.setdefault("ckpt_dir", ckpt_dir)
        rt = cls(requests, transport, workers, **kw)
        if list(rt.worker_names) != list(meta["workers"]):
            raise ValueError(
                f"checkpointed fleet {meta['workers']} does not match "
                f"the given workers {rt.worker_names}")
        flat = ckptlib.load_flat(ckpt_dir, step)
        rt._emitted = set(int(i) for i in flat["emitted"])
        rt._n_pulled = int(flat["n_pulled"])
        rt._rr = int(flat["rr"])
        rt._cycle = int(meta["cycle"])
        rt._elapsed0 = float(flat["elapsed"])
        for wi, v in zip(flat["seq_names"], flat["seq_vals"]):
            if int(wi) >= 0:
                rt._seq[rt.worker_names[int(wi)]] = int(v)
        rt._attempts = {int(i): int(n) for i, n in
                        zip(flat["attempts_idx"], flat["attempts_n"])}
        rt._restore = dict(
            pending=[int(i) for i in flat["pending"]],
            inflight=[int(i) for i in flat["inflight_idx"]])
        return rt

    def _replay_feed(self) -> None:
        info, self._restore = self._restore, None
        requeue = sorted(info["inflight"])
        needed = set(info["pending"]) | set(requeue)
        for j in range(self._n_pulled):
            try:
                sc = next(self._feed)
            except StopIteration:
                raise ValueError(
                    "resume feed is shorter than the checkpointed pull "
                    "count — resume() must replay the same feed")
            if j in needed:
                self._requests[j] = sc
        # queued first (their dispatch was still owed), then the
        # in-flight table — those workers died with the old process
        for i in info["pending"]:
            self._pending.append((i, self._requests[i]))
        for i in requeue:
            self._pending.append((i, self._requests[i]))

    # -- placement -----------------------------------------------------------
    def _dispatch(self, now: float) -> None:
        """Fill free worker capacity from the queue: most-free placement
        with round-robin tie-break over eligible (alive, not backing
        off) workers — ``next_admission_shard`` over router-side
        accounting, the streaming engine's placement shape across hosts."""
        if not self._pending:
            return
        used = {n: 0 for n in self.worker_names}
        for rec in self._inflight.values():
            used[rec["worker"]] += 1
        free = []
        for n in self.worker_names:
            eligible = (self._alive(n)
                        and now >= self._backoff_until[n])
            free.append(max(0, self.capacity[n] - used[n])
                        if eligible else 0)
        while self._pending:
            shard = next_admission_shard(free, self._rr)
            if shard is None:
                return
            self._rr = (shard + 1) % len(free)
            idx, sc = self._pending.popleft()
            name = self.worker_names[shard]
            attempts = self._attempts.get(idx, 0) + 1
            self._attempts[idx] = attempts
            self._inflight[idx] = dict(worker=name, sent_at=now,
                                       attempts=attempts)
            self._send(name, "req", index=idx, payload=sc)
            free[shard] -= 1

    # -- the serve loop ------------------------------------------------------
    def serve(self) -> Iterator[StreamResult]:
        if self._served:
            raise RuntimeError("serve() already consumed this router's "
                               "feed — build a new router to replay")
        self._served = True
        self._t0 = self.transport.now()
        if self._restore is not None:
            self._replay_feed()
        c = self._counters

        def emit(res):
            c["n_results"] += 1
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

        while True:
            self._cycle += 1
            if self._cycle > self.max_cycles:
                raise RuntimeError(
                    f"fleet router exceeded max_cycles={self.max_cycles} "
                    f"with {len(self._pending)} queued / "
                    f"{len(self._inflight)} in flight — wedged")
            # snapshot FIRST, crash second (the chaos kill model): a
            # resumed router re-emits nothing this cycle produced
            self._maybe_checkpoint()
            if self.chaos is not None:
                self.chaos.maybe_kill(self._cycle)
            now = self._now()
            # -- gather: results / heartbeats --------------------------------
            for env in self.transport.recv(ROUTER):
                link = self._links.setdefault(env.src, _LinkDedup())
                if not link.fresh(env.seq):
                    continue
                if env.src in self.worker_names:
                    # any envelope proves liveness (a dropped worker
                    # that reconnects rejoins the eligible set), but
                    # only a *delivered result* clears the strike
                    # ladder — heartbeats alone must not mask a worker
                    # whose ingress link is cut
                    if env.src in self._dead:
                        self._rejoin(env.src)
                    if self.monitor is not None:
                        self.monitor.heartbeat(self._widx[env.src])
                if env.kind != "result":
                    continue
                self._strikes[env.src] = 0
                self._backoff_until[env.src] = 0.0
                # ACK every delivery — the sender keeps retransmitting
                # until one lands, duplicates included
                self._send(env.src, "ack", index=env.index)
                res = env.payload
                if res.index in self._emitted:
                    c["n_dup_results"] += 1
                    continue
                self._inflight.pop(res.index, None)
                self._requests.pop(res.index, None)
                self._attempts.pop(res.index, None)
                res.emit_s = self._now_trace(now)
                emit(res)
                yield res
            # -- worker loss (heartbeat silence) -----------------------------
            if self.monitor is not None:
                for h in self.monitor.dead():
                    name = self.worker_names[h]
                    if self._alive(name):
                        self._drop_worker(name)
            # -- per-request timeout -> retry budget -------------------------
            for idx in sorted(self._inflight):
                rec = self._inflight[idx]
                budget = (self.request_timeout
                          * (2 ** (rec["attempts"] - 1)))
                if now - rec["sent_at"] < budget:
                    continue
                c["n_timeouts"] += 1
                self._strike(rec["worker"], now)
                if idx not in self._inflight:
                    continue    # the strike dropped the worker: requeued
                rec = self._inflight.pop(idx)
                if rec["attempts"] >= self.max_attempts:
                    c["n_undeliverable"] += 1
                    res = self._degrade(idx, self._requests[idx], now,
                                        "undeliverable")
                    emit(res)
                    yield res
                else:
                    c["n_retries"] += 1
                    self._pending.append((idx, self._requests[idx]))
            # -- pull + dispatch ---------------------------------------------
            for res in self._pull(now):
                emit(res)
                yield res
            if not any(self._alive(n) for n in self.worker_names):
                # graceful degradation: no host can take work — answer
                # every owed request degraded rather than wedge/raise
                drain = sorted(set(i for i, _ in self._pending)
                               | set(self._inflight))
                self._pending.clear()
                for idx in drain:
                    c["n_undeliverable"] += 1
                    res = self._degrade(idx, self._requests[idx], now,
                                        "undeliverable")
                    emit(res)
                    yield res
                if self._feed_done:
                    break
            self._dispatch(now)
            # -- advance the fleet -------------------------------------------
            self.transport.tick()
            for w in self._drive:
                w.step()
            if (self._feed_done and not self._pending
                    and not self._inflight):
                break
            if not self._drive:
                # socket mode: results arrive asynchronously — pace the
                # loop instead of busy-polling (cycle-clock transports
                # advance time through tick, real ones through sleep)
                time.sleep(self.poll_s)
        for n in self.worker_names:
            if self._alive(n):
                self._send(n, "stop")
        self.transport.tick()
        for w in self._drive:
            w.step()
        self._stats = dict(
            cycles=self._cycle,
            n_workers=len(self.worker_names),
            workers_dead=sorted(self._dead),
            deadline_hit_rate=(
                c["deadline_hits"] / c["deadline_total"]
                if c["deadline_total"] else 1.0),
            transport=dict(getattr(self.transport, "stats", {})),
            **dict(c))

    def run(self) -> List:
        """Drain the feed; plain ``BOResult``s in arrival order (what
        THIS router emitted — merge pre-crash streams with
        ``dedup_results`` first when resuming)."""
        out = {}
        for r in self.serve():
            out[r.index] = r.result
        return [out[i] for i in sorted(out)]

    def fleet_stats(self) -> dict:
        return dict(self._stats)


def sim_fleet(requests: Sequence[Scenario], n_workers: int = 2,
              config=None, *, n_lanes: int = 4,
              l_pad: Optional[int] = None,
              budget_max: Optional[int] = None,
              chaos=None, worker_kw: Optional[dict] = None,
              device="cuda", **router_kw) -> FleetRouter:
    """Wire a complete simulated fleet: one :class:`SimTransport` (with
    ``chaos`` attached), ``n_workers`` :class:`FleetWorker`s of
    ``n_lanes`` each on ``device`` (the card unless the caller asks for
    the CPU), one :class:`FleetRouter` over a materialized feed. The
    static shapes default to the feed's maxima, mirroring the
    single-process engine."""
    reqs = list(requests)
    if l_pad is None:
        l_pad = max((sc.problem.L for sc in reqs), default=1)
    if budget_max is None:
        budget_max = max((sc.budget for sc in reqs), default=1)
    names = [f"w{i}" for i in range(n_workers)]
    transport = SimTransport([ROUTER] + names, chaos=chaos)
    workers = [FleetWorker(n, transport, config, l_pad=l_pad,
                           budget_max=budget_max, n_lanes=n_lanes,
                           device=device, **(worker_kw or {}))
               for n in names]
    router_kw.setdefault("l_pad", l_pad)
    router_kw.setdefault("budget_max", budget_max)
    return FleetRouter(reqs, transport, workers, chaos=chaos,
                       **router_kw)


__all__ = ["Envelope", "Transport", "SimTransport", "SocketTransport",
           "FleetWorker", "FleetRouter", "sim_fleet", "socket_fleet",
           "dedup_results", "ROUTER", "ENVELOPE_KINDS"]
