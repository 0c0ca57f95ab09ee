"""The streaming server's host code against the reference, exactly
(parity level 1): the channel and arrival trace generators
(``repro_torch.wireless.traces``), the admission half of
``repro_torch.distributed.sharding`` and ``HeartbeatMonitor``
(``repro_torch.distributed.fault_tolerance``). Same seeds and inputs
give the same lists and arrays, bit for bit; no tolerance.
"""
import json

import numpy as np
import pytest

from repro.core.batch_bo import scenario_from_request as ref_request
from repro.distributed import fault_tolerance as rft
from repro.distributed import sharding as rsh
from repro.runtime.stream import requests_from_trace as ref_decode
from repro.wireless import traces as rtr
from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding as sh
from repro_torch.runtime.stream import requests_from_trace
from repro_torch.wireless import traces as tr


def test_constants_are_the_reference_s():
    assert tr.ARRIVAL_KINDS == rtr.ARRIVAL_KINDS
    assert tr.LM_TRACE_ARCHS == rtr.LM_TRACE_ARCHS
    assert tr.MIXED_TRACE_ARCHS == rtr.MIXED_TRACE_ARCHS
    assert tr._PER_ARRIVAL_KEYS == rtr._PER_ARRIVAL_KEYS
    assert sh.ADMISSION_POLICIES == rsh.ADMISSION_POLICIES
    assert sh.ROUTE_WALL_DEADBAND == rsh.ROUTE_WALL_DEADBAND


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=3, n_frames=100), dict(fading_std_db=4.0,
                                            blockage_rate=0.2)])
def test_mmobile_trace_and_frame_stats(kw):
    got, want = tr.synth_mmobile_trace(**kw), rtr.synth_mmobile_trace(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tr.frame_stats(got) == rtr.frame_stats(want)


@pytest.mark.parametrize("fn,kw", [
    ("poisson_arrivals", dict(n=50, rate_hz=5.0, seed=2)),
    ("bursty_arrivals", dict(n=37, burst_len=5, seed=1)),
    ("replay_arrivals", dict(n=20, frame_period_s=0.05))])
def test_arrival_processes(fn, kw):
    got, want = getattr(tr, fn)(**kw), getattr(rtr, fn)(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kw", [
    dict(kind="poisson", n=128, seed=0, budgets=(6, 10, 14, 20),
         archs=tr.MIXED_TRACE_ARCHS),
    dict(kind="bursty", n=40, seed=5, budgets=(6, 10, 14),
         deadline_slack=(1.0, 6.0), load=4.0),
    dict(kind="replay", n=500, seed=1),
    dict(kind="poisson", n=12, seed=0, budgets=(6, 10), rate_hz=5.0)])
def test_arrival_trace(kw):
    got = tr.arrival_trace(**kw)
    assert got == rtr.arrival_trace(**kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        rtr.arrival_trace(**kw), sort_keys=True)


@pytest.mark.parametrize("kw", [dict(kind="gamma"), dict(load=0.0)])
def test_arrival_trace_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        rtr.arrival_trace(**kw)
    with pytest.raises(ValueError):
        tr.arrival_trace(**kw)


@pytest.mark.parametrize("n_hosts,seed", [(1, 0), (3, 7), (8, 2)])
def test_split_and_merge(n_hosts, seed):
    trace = tr.arrival_trace("bursty", n=30, seed=4,
                             deadline_slack=(0.5, 2.0))
    subs = tr.split_trace(trace, n_hosts, seed)
    assert subs == rtr.split_trace(trace, n_hosts, seed)
    assert tr.merge_traces(subs) == rtr.merge_traces(subs) == trace
    with pytest.raises(ValueError):
        tr.merge_traces(subs[1:] if n_hosts > 1 else [])


def test_save_load_across_packages(tmp_path):
    trace = tr.arrival_trace("poisson", n=16, seed=9,
                             archs=tr.MIXED_TRACE_ARCHS)
    tr.save_trace(trace, str(tmp_path / "port.json"))
    rtr.save_trace(trace, str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "ref.json").read_text()
    assert rtr.load_trace(str(tmp_path / "port.json")) == trace
    assert tr.load_trace(str(tmp_path / "ref.json")) == trace


def test_requests_from_trace_decodes_as_the_reference():
    trace = tr.arrival_trace("bursty", n=24, seed=2,
                             archs=tr.MIXED_TRACE_ARCHS,
                             deadline_slack=(0.5, 3.0))
    got, want = requests_from_trace(trace), ref_decode(trace)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert (a.seed, a.budget, a.deadline_s) == (b.seed, b.budget,
                                                     b.deadline_s)
        assert a.problem.L == b.problem.L
        assert a.problem.gain_db == b.problem.gain_db
        assert (a.problem.p_min, a.problem.p_max) == (b.problem.p_min,
                                                      b.problem.p_max)
    sc = scenario_from_request("rwkv6-3b", -1.5, 8, 3, deadline_s=2.0)
    rc = ref_request("rwkv6-3b", -1.5, 8, 3, deadline_s=2.0)
    assert sc.problem.gain_db == rc.problem.gain_db
    assert sc.deadline_s == rc.deadline_s == 2.0


# ---------------------------------------------------------------------------
# admission placement
# ---------------------------------------------------------------------------


def _pending(rng, n):
    out = []
    for i in range(n):
        d = None if rng.random() < 0.3 else float(rng.uniform(-1.0, 5.0))
        out.append((int(rng.integers(0, 100)),
                    scenario_from_request("vgg19", 0.0, 6, i,
                                          deadline_s=d)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_admission_order(seed):
    rng = np.random.default_rng(seed)
    pending = _pending(rng, 12)
    now = float(rng.uniform(0.0, 2.0))
    for policy in ("fifo", "edf", lambda p, t: list(range(len(p)))[::-1]):
        assert (sh.admission_order(pending, now, policy)
                == rsh.admission_order(pending, now, policy))
    # a deadline-free queue under EDF is the FIFO order
    free = [(i, scenario_from_request("vgg19", 0.0, 6, i)) for i in range(5)]
    assert sh.admission_order(free, now, "edf") == list(range(5))
    with pytest.raises(ValueError):
        sh.admission_order(pending, now, "lifo")


@pytest.mark.parametrize("seed", range(4))
def test_next_and_route_admission_shard(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        free = [int(v) for v in rng.integers(0, 5, size=n)]
        rr = int(rng.integers(0, n))
        assert (sh.next_admission_shard(free, rr)
                == rsh.next_admission_shard(free, rr))
        feats = []
        for f in free:
            d = dict(free=f)
            if rng.random() < 0.3:
                d["backoff"] = True
            if rng.random() < 0.5:
                d["ewma_wall_s"] = float(rng.uniform(0.1, 5.0))
            if rng.random() < 0.3:
                d["stale_frac"] = float(rng.uniform(0.0, 3.0))
            feats.append(d)
        ref = None if rng.random() < 0.5 else float(rng.uniform(0.1, 2.0))
        assert (sh.route_admission_shard(feats, rr, wall_ref=ref)
                == rsh.route_admission_shard(feats, rr, wall_ref=ref))
        # a healthy fleet routes as most-free round-robin
        assert (sh.route_admission_shard([dict(free=f) for f in free], rr)
                == sh.next_admission_shard(free, rr))


# ---------------------------------------------------------------------------
# the heartbeat monitor
# ---------------------------------------------------------------------------


def _drive(mod, seed):
    """One seeded script of reports, pings and queries against ``mod``'s
    monitor on an injected clock; returns everything it answered."""
    rng = np.random.default_rng(seed)
    t = [100.0]
    mon = mod.HeartbeatMonitor(4, window=6, dead_timeout_s=3.0,
                               clock=lambda: t[0])
    seen = [dict(mon.last_seen)]
    for _ in range(120):
        t[0] += float(rng.uniform(0.0, 0.8))
        h = int(rng.integers(0, 4))
        op = rng.random()
        if op < 0.5:
            mon.report(h, float(1.0 + (3.0 if h == 2 else 0.0)
                                + rng.random()))
        elif op < 0.7:
            mon.heartbeat(h)
        elif op < 0.85:
            seen.append(("stragglers", mon.stragglers()))
        else:
            seen.append(("dead", mon.dead()))
        seen.append({k: list(v) for k, v in mon.step_times.items()})
    return seen


@pytest.mark.parametrize("seed", range(3))
def test_heartbeat_monitor_is_the_reference_s(seed):
    assert _drive(ft, seed) == _drive(rft, seed)


def test_heartbeat_monitor_reference_cases():
    """The reference's own monitor cases, on the port's monitor."""
    mon = ft.HeartbeatMonitor(n_hosts=8, window=10)
    for step in range(10):
        for h in range(8):
            mon.report(h, 1.0 + (2.5 if h == 3 else 0.0), now=100.0 + step)
    assert mon.stragglers(now=109.0) == [3]
    assert mon.dead(now=170.0) == list(range(8))
    mon = ft.HeartbeatMonitor(n_hosts=2, window=10, dead_timeout_s=5.0)
    for step in range(10):
        mon.report(0, 1.0, now=100.0 + step)
        mon.report(1, 9.0, now=100.0 + step)
    assert mon.dead(now=200.0) == [0, 1]
    assert mon.step_times == {0: [], 1: []}
    import time
    assert ft.HeartbeatMonitor(1).clock is time.monotonic
