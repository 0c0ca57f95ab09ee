"""The port's fleet front end (``repro_torch.runtime.fleet``) on the CPU.

Mirrors ``tests/test_fleet.py`` case for case. Each case runs the port's
fleet and the reference's on the same requests, seeds and fault
schedules, and holds

* the port within itself as the reference holds itself: a zero-fault
  fleet, and every fleet that recovers, equals the single-host cold
  stream bit for bit (the last level-4 contract of the port), and every
  request emits exactly one result after dedup;
* the port against the reference: the same transport history (delivery
  traces, chaos event logs, the undelivered table), the same fleet
  counters, and per request the same quantized answers (parity level 3:
  eval count, accuracy and feasibility equal, incumbent traces within
  one 1/64 quantum).

Added: every envelope kind pickles round trip with host data only, a
worker refuses a result that holds a tensor, and a router checkpoint
resumes across packages both ways.
"""
import functools
import json
import os
import pickle
import threading
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core.batch_bo import scenario_from_request as ref_request
from repro.core.engine_config import EngineConfig as RefConfig
from repro.runtime import chaos as ref_chaos
from repro.runtime import fleet as ref_fleet
from repro.runtime import stream as ref_stream
from repro.wireless import traces as ref_traces
from repro_torch.core import acquisition
from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.core.engine_config import EngineConfig
from repro_torch.runtime import chaos as port_chaos
from repro_torch.runtime import fleet as port_fleet
from repro_torch.runtime import stream as port_stream
from repro_torch.runtime.fleet import (ENVELOPE_KINDS, ROUTER, Envelope,
                                       FleetRouter, FleetWorker,
                                       SimTransport, _LinkDedup, socket_fleet)
from repro_torch.runtime.stream import StreamResult, dedup_results
from repro_torch.wireless import traces as port_traces

torch.set_num_threads(1)
QUANTUM = 100.0 / 64.0               # one accuracy quantum (level 3)

REF = SimpleNamespace(
    name="reference", request=ref_request, cold=RefConfig(warm_start=False),
    sim_fleet=ref_fleet.sim_fleet, FleetWorker=ref_fleet.FleetWorker,
    FleetRouter=ref_fleet.FleetRouter, SimTransport=ref_fleet.SimTransport,
    Envelope=ref_fleet.Envelope, NetworkChaos=ref_chaos.NetworkChaos,
    SimulatedCrash=ref_chaos.SimulatedCrash,
    Stream=ref_stream.StreamingBayesSplitEdge,
    requests_from_trace=ref_stream.requests_from_trace,
    dedup_results=ref_stream.dedup_results, traces=ref_traces)
PORT = SimpleNamespace(
    name="port", request=scenario_from_request,
    cold=EngineConfig(warm_start=False),
    sim_fleet=functools.partial(port_fleet.sim_fleet, device="cpu"),
    FleetWorker=functools.partial(port_fleet.FleetWorker, device="cpu"),
    FleetRouter=port_fleet.FleetRouter, SimTransport=port_fleet.SimTransport,
    Envelope=port_fleet.Envelope, NetworkChaos=port_chaos.NetworkChaos,
    SimulatedCrash=port_chaos.SimulatedCrash,
    Stream=functools.partial(port_stream.StreamingBayesSplitEdge,
                             device="cpu"),
    requests_from_trace=port_stream.requests_from_trace,
    dedup_results=port_stream.dedup_results, traces=port_traces)
BOTH = (PORT, REF)


def _reqs(pkg, n=10, budgets=(6, 8, 10)):
    return [pkg.request("vgg19", (-1) ** i * 1.5, budgets[i % len(budgets)],
                        i) for i in range(n)]


@pytest.fixture(scope="module")
def single10():
    """Single-process cold streams of the standard 10-request feed, by
    package."""
    return {pkg.name: pkg.Stream(_reqs(pkg, 10), pkg.cold, n_lanes=8).run()
            for pkg in BOTH}


def _assert_bitwise(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.n_evals == b.n_evals, f"request {i}: n_evals"
        assert np.array_equal(np.asarray(a.utilities),
                              np.asarray(b.utilities)), f"request {i}"
        assert np.array_equal(np.asarray(a.incumbent_trace),
                              np.asarray(b.incumbent_trace)), f"request {i}"


def _assert_level3(port, ref):
    """The port's results against the reference's: eval counts,
    accuracies and feasibility equal, traces within one quantum."""
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert (a.n_evals, a.best_accuracy, a.best_a is None) == (
            b.n_evals, b.best_accuracy, b.best_a is None), f"request {i}"
        np.testing.assert_allclose(a.incumbent_trace, b.incumbent_trace,
                                   rtol=0, atol=QUANTUM)


def _both(case):
    """Run ``case(pkg)`` for the port and the reference; returns
    ``(port outcome, reference outcome)``."""
    return case(PORT), case(REF)


# -- envelope / transport units ----------------------------------------------

def _dedup_script(cls):
    d = cls()
    out = [d.fresh(0), d.fresh(1), d.fresh(0), d.fresh(1), d.fresh(4),
           d.fresh(3), d.fresh(4), d.fresh(2)]
    out += [d.lo, sorted(d.seen), d.fresh(1)]
    return out


def test_link_dedup_laws():
    d = _LinkDedup()
    assert d.fresh(0) and d.fresh(1)
    assert not d.fresh(0) and not d.fresh(1)      # duplicates collapse
    assert d.fresh(4) and d.fresh(3)              # reordered arrivals pass
    assert not d.fresh(4)
    assert d.fresh(2)
    assert d.lo == 5 and not d.seen
    assert not d.fresh(1)
    assert _dedup_script(_LinkDedup) == _dedup_script(ref_fleet._LinkDedup)


def _scripted_send(pkg, chaos):
    """Send a fixed envelope script through a SimTransport and return
    (delivery trace, event log, transport)."""
    t = pkg.SimTransport([ROUTER, "w0", "w1"], chaos=chaos)
    trace = []
    seq = {w: 0 for w in ("w0", "w1")}
    for cyc in range(12):
        for w in ("w0", "w1"):
            t.send(pkg.Envelope(seq=seq[w], src=ROUTER, dst=w, kind="req",
                                index=cyc))
            seq[w] += 1
        t.tick()
        for w in ("w0", "w1"):
            trace.append((cyc, w, [e.seq for e in t.recv(w)]))
    return trace, None if chaos is None else list(chaos.events), t


def _sim_chaos(pkg):
    return pkg.NetworkChaos(seed=13, drop_rate=0.2, dup_rate=0.2,
                            reorder_rate=0.5, delay_max=2,
                            partition_at=[(5, ROUTER, "w1")],
                            heal_at=[(9, "*", "*")])


def test_sim_transport_deterministic():
    tr1, ev1, t1 = _scripted_send(PORT, _sim_chaos(PORT))
    tr2, ev2, _ = _scripted_send(PORT, _sim_chaos(PORT))
    assert tr1 == tr2, "delivery must be seed-pure"
    assert ev1 == ev2, "event log must be seed-pure"
    assert any(e["kind"] == "partition_drop" for e in ev1)
    tr0, _, t0 = _scripted_send(PORT, None)
    assert all(seqs == [c] for c, _, seqs in tr0)
    assert t0.stats["dropped"] == 0 and not t0.undelivered_table()
    # the reference's transport gives the same history
    rtr, rev, rt = _scripted_send(REF, _sim_chaos(REF))
    assert (tr1, ev1, t1.stats) == (rtr, rev, rt.stats)
    assert t1.undelivered_table() == rt.undelivered_table()


def test_network_chaos_partition_wildcards_and_artifacts(tmp_path):
    def case(pkg):
        ch = pkg.NetworkChaos(seed=0, partition_at=[(1, "w0", "*"),
                                                    (1, "*", "w0")],
                              heal_at=[(4, "*", "*")])
        ch.step(1)
        blocked = [ch.blocked("w0", ROUTER), ch.blocked(ROUTER, "w0"),
                   ch.blocked("w1", ROUTER)]
        ch.step(4)
        blocked.append(ch.blocked("w0", ROUTER))
        return ch, blocked

    (ch, blocked), (rch, rblocked) = _both(case)
    assert blocked == [True, True, False, False] == rblocked
    path = str(tmp_path / "net_events.json")
    ch.save_events(path)
    back = port_chaos.load_events(path)
    assert back["seed"] == 0 and back["events"] == ch.events
    kinds = [e["kind"] for e in ch.events]
    assert kinds.count("partition") == 2 and kinds.count("heal") == 1
    assert ch.events == rch.events
    assert ref_chaos.load_events(path) == back    # readable by either


def test_undelivered_table_accounts_losses():
    def case(pkg):
        t = pkg.SimTransport([ROUTER, "w0"],
                             chaos=pkg.NetworkChaos(seed=1, drop_rate=1.0))
        t.send(pkg.Envelope(seq=0, src=ROUTER, dst="w0", kind="req",
                            index=7))
        return t.undelivered_table()

    rows, ref_rows = _both(case)
    assert [r["fate"] for r in rows] == ["lost"]
    assert rows[0]["index"] == 7 and rows[0]["msg"] == "req"
    assert rows == ref_rows


# -- the replay-match contract ------------------------------------------------

def _run_fleet(pkg, feed, **kw):
    rt = pkg.sim_fleet(feed, config=pkg.cold, **kw)
    seen = []
    rt.on_result = seen.append
    return rt, rt.run(), seen


def test_zero_fault_fleet_matches_single_host_bitwise(single10):
    scorings = []
    score = acquisition.block_scores
    with mock.patch.object(acquisition, "block_scores",
                           lambda *a, **k: scorings.append(1) or score(
                               *a, **k)):
        rt, got, _ = _run_fleet(PORT, _reqs(PORT, 10), n_workers=2,
                                n_lanes=4)
    rrt, rgot, _ = _run_fleet(REF, _reqs(REF, 10), n_workers=2, n_lanes=4)
    _assert_bitwise(got, single10["port"])
    # each worker counts its dispatches and the LANE_WIDTH chunks of its
    # acquisition iterations: one block scoring (a posterior launch on
    # the card) a chunk
    chunks = sum(w.eng._counters["acq_chunks"] for w in rt._drive)
    assert chunks == len(scorings) > 0
    assert all(w.counters["n_dispatches"] > 0 for w in rt._drive)
    st = rt.fleet_stats()
    assert st["n_retries"] == 0 and st["n_degraded"] == 0
    assert st["transport"]["dropped"] == 0
    assert st == rrt.fleet_stats()
    _assert_level3(got, rgot)


def test_lossy_exactly_once_and_bitwise(single10):
    (rt, got, seen), (rrt, rgot, _) = _both(lambda pkg: _run_fleet(
        pkg, _reqs(pkg, 10), n_workers=2, n_lanes=4,
        chaos=pkg.NetworkChaos(seed=3, drop_rate=0.15, dup_rate=0.1,
                               reorder_rate=0.3, delay_max=2),
        request_timeout=24.0, max_attempts=5))
    assert sorted(r.index for r in seen) == list(range(10))  # exactly-once
    _assert_bitwise(got, single10["port"])
    assert rt.fleet_stats()["transport"]["dropped"] > 0  # faults did fire
    assert rt.fleet_stats() == rrt.fleet_stats()
    _assert_level3(got, rgot)


def test_partition_heal_drains_and_reconciles(single10):
    def case(pkg):
        ch = pkg.NetworkChaos(seed=5, partition_at=[(3, "w0", ROUTER)],
                              heal_at=[(30, "*", "*")])
        rt, got, _ = _run_fleet(pkg, _reqs(pkg, 10), n_workers=2,
                                n_lanes=4, chaos=ch, request_timeout=10.0,
                                max_attempts=6)
        return rt, got, ch

    (rt, got, ch), (rrt, rgot, rch) = _both(case)
    _assert_bitwise(got, single10["port"])
    st = rt.fleet_stats()
    assert st["n_timeouts"] >= 1          # the cut was noticed
    assert st["n_degraded"] == 0          # ... and fully recovered
    assert "partition" in [e["kind"] for e in ch.events]
    assert st == rrt.fleet_stats() and ch.events == rch.events
    _assert_level3(got, rgot)


def test_total_partition_degrades_never_silent():
    def case(pkg):
        ch = pkg.NetworkChaos(seed=7, partition_at=[(3, "w0", "*"),
                                                    (3, "*", "w0")])
        return _run_fleet(pkg, _reqs(pkg, 6), n_workers=1, n_lanes=4,
                          chaos=ch, request_timeout=6.0, max_attempts=3,
                          hb_timeout=8.0)

    (rt, got, seen), (rrt, rgot, rseen) = _both(case)
    assert len(got) == 6
    assert sorted(r.index for r in seen) == list(range(6))
    st = rt.fleet_stats()
    assert st["n_undeliverable"] >= 1
    assert st["n_worker_dead"] == 1
    und = [r for r in seen if r.degraded]
    assert und and all(r.reason == "undeliverable" for r in und)
    assert st == rrt.fleet_stats()
    assert [(r.index, r.degraded, r.reason) for r in seen] == [
        (r.index, r.degraded, r.reason) for r in rseen]
    _assert_level3(got, rgot)


def test_worker_loss_heartbeat_requeues_to_survivor(single10):
    (rt, got, _), (rrt, rgot, _) = _both(lambda pkg: _run_fleet(
        pkg, _reqs(pkg, 10), n_workers=2, n_lanes=4,
        chaos=pkg.NetworkChaos(seed=9, partition_at=[(2, "w0", "*"),
                                                     (2, "*", "w0")]),
        request_timeout=50.0, max_attempts=6, hb_timeout=6.0))
    _assert_bitwise(got, single10["port"])
    st = rt.fleet_stats()
    assert st["workers_dead"] == ["w0"]
    assert st["n_degraded"] == 0
    assert st == rrt.fleet_stats()
    _assert_level3(got, rgot)


def _killed(pkg, d, n=10, budgets=(6, 8, 10), kill_at=4):
    """A fleet with ``ckpt_every=1`` whose router the chaos kills at
    cycle ``kill_at``; returns (router, results emitted before)."""
    ch = pkg.NetworkChaos(seed=11, kill_router_at=[kill_at])
    rt = pkg.sim_fleet(_reqs(pkg, n, budgets), n_workers=2, config=pkg.cold,
                       n_lanes=4, chaos=ch, ckpt_dir=d, ckpt_every=1)
    pre = []
    with pytest.raises(pkg.SimulatedCrash):
        for r in rt.serve():
            pre.append(r)
    return rt, pre


def _resumed(pkg, d, rt, n=10, budgets=(6, 8, 10)):
    names = ["w0", "w1"]
    t2 = pkg.SimTransport([ROUTER] + names)
    ws = [pkg.FleetWorker(nm, t2, pkg.cold, l_pad=rt.l_pad,
                          budget_max=rt.budget_max, n_lanes=4)
          for nm in names]
    rt2 = pkg.FleetRouter.resume(d, _reqs(pkg, n, budgets), t2, ws,
                                 l_pad=rt.l_pad, budget_max=rt.budget_max)
    return list(rt2.serve())


def _assert_resumed(pre, post, single):
    pre_idx = {r.index for r in pre}
    post_idx = [r.index for r in post]
    assert pre, "the kill must land after some emissions"
    assert len(post_idx) == len(set(post_idx))
    assert not (pre_idx & set(post_idx)), "resumed router double-emitted"
    merged = {r.index: r.result for r in dedup_results(pre + post)}
    assert sorted(merged) == list(range(10))
    _assert_bitwise([merged[i] for i in sorted(merged)], single)
    return pre_idx


def test_router_kill_resume_never_double_emits(tmp_path, single10):
    def case(pkg):
        d = str(tmp_path / pkg.name)
        rt, pre = _killed(pkg, d)
        return pre, _resumed(pkg, d, rt)

    (pre, post), (rpre, rpost) = _both(case)
    pre_idx = _assert_resumed(pre, post, single10["port"])
    assert pre_idx == {r.index for r in rpre}
    assert [r.index for r in post] == [r.index for r in rpost]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_router_checkpoint_resumes_across_packages(tmp_path, single10,
                                                   writer, reader):
    """A router killed in one package resumes from its checkpoint in the
    other: the merged stream is exactly-once, and the resumed part
    equals the reader's single-host stream bit for bit."""
    d = str(tmp_path / "ckpt")
    rt, pre = _killed(writer, d)
    post = _resumed(reader, d, rt)
    pre_idx = {r.index for r in pre}
    post_idx = [r.index for r in post]
    assert pre and len(post_idx) == len(set(post_idx))
    assert not (pre_idx & set(post_idx))
    assert sorted(pre_idx | set(post_idx)) == list(range(10))
    single = single10[reader.name]
    _assert_bitwise([r.result for r in post],
                    [single[r.index] for r in post])


def test_resume_rejects_wrong_fleet_and_foreign_checkpoints(tmp_path):
    for pkg in BOTH:
        d = str(tmp_path / pkg.name)
        rt, _ = _killed(pkg, d, n=4, budgets=(6,), kill_at=2)
        t2 = pkg.SimTransport([ROUTER, "w0"])
        w = pkg.FleetWorker("w0", t2, pkg.cold, l_pad=rt.l_pad,
                            budget_max=rt.budget_max, n_lanes=4)
        with pytest.raises(ValueError, match="does not match"):
            pkg.FleetRouter.resume(d, _reqs(pkg, 4, budgets=(6,)), t2, [w])
        with pytest.raises(FileNotFoundError):
            pkg.FleetRouter.resume(str(tmp_path / "nope"), _reqs(pkg, 4),
                                   t2, [w])


def test_oversized_requests_reject_degraded():
    def case(pkg):
        rs = _reqs(pkg, 4, budgets=(6,)) + _reqs(pkg, 1, budgets=(40,))
        return _run_fleet(pkg, rs, n_workers=1, n_lanes=4, budget_max=10)

    (rt, got, seen), (rrt, rgot, rseen) = _both(case)
    assert len(got) == 5
    by = {r.index: r for r in seen}
    assert by[4].degraded and by[4].reason == "rejected"
    assert not any(by[i].degraded for i in range(4))
    assert rt.fleet_stats() == rrt.fleet_stats()
    _assert_level3(got, rgot)


# -- envelopes carry host data only -------------------------------------------

def test_every_envelope_kind_pickles_round_trip():
    """What ``SocketTransport`` sends: each kind with the payload the
    fleet gives it (a request's Scenario, a worker's StreamResult, a
    heartbeat's dict), pickled and back, holding no tensor."""
    reqs = _reqs(PORT, 2, budgets=(6,))
    rt, _, seen = _run_fleet(PORT, reqs, n_workers=1, n_lanes=2)
    res = seen[0]
    payloads = dict(req=reqs[0], result=res, ack=None,
                    hb=dict(free=2), stop=None)
    assert set(payloads) == set(ENVELOPE_KINDS)
    for seq, kind in enumerate(ENVELOPE_KINDS):
        env = Envelope(seq=seq, src=ROUTER, dst="w0", kind=kind,
                       index=res.index if kind == "result" else -1,
                       payload=payloads[kind])
        back = pickle.loads(pickle.dumps(env))
        assert back.brief() == env.brief()
        port_fleet._check_host(back.payload, kind)
    back = pickle.loads(pickle.dumps(res))
    _assert_bitwise([back.result], [res.result])
    assert all(isinstance(v, (np.ndarray, np.generic))
               for v in back.raw.values())
    assert all(v.tobytes() == res.raw[k].tobytes()
               for k, v in back.raw.items())


def test_worker_refuses_a_result_holding_a_tensor():
    res = StreamResult(index=0, scenario=None, result=None, pool=0, lane=0,
                       gen=0, raw=dict(ev_u=torch.zeros(3)))
    with pytest.raises(TypeError, match="host data only"):
        port_fleet._check_host(res.raw, "raw")
    port_fleet._check_host(dict(ev_u=np.zeros(3), n=[1, 2]), "raw")


# -- the real-network adapter -------------------------------------------------

def test_socket_loopback_smoke():
    reqs = _reqs(PORT, 4, budgets=(6,))
    ref = PORT.Stream(reqs, PORT.cold, n_lanes=4).run()
    rt_t, w_ts = socket_fleet(1, device="cpu")
    try:
        assert w_ts[0].device == torch.device("cpu")
        w = FleetWorker("w0", w_ts[0], PORT.cold,
                        l_pad=max(s.problem.L for s in reqs),
                        budget_max=6, n_lanes=4, resend_after=0.5)
        assert w.eng.device == torch.device("cpu")
        th = threading.Thread(target=w.run_loop, daemon=True)
        th.start()
        rt = FleetRouter(reqs, rt_t, ["w0"], capacity={"w0": 4},
                         request_timeout=60.0, max_attempts=3)
        got = rt.run()
        th.join(timeout=20)
        assert w._stopped, "worker must see the stop envelope"
        _assert_bitwise(got, ref)
    finally:
        rt_t.close()
        for t in w_ts:
            t.close()


# -- fleet trace sharding (wireless/traces.py) --------------------------------

def test_split_trace_roundtrips_and_recomposes(tmp_path):
    tr = port_traces.arrival_trace("bursty", n=23, seed=4,
                                   deadline_slack=(0.5, 2.0))
    subs = port_traces.split_trace(tr, 3, seed=1)
    assert [s["host"] for s in subs] == [0, 1, 2]
    assert sum(s["n"] for s in subs) == 23
    assert port_traces.split_trace(tr, 3, seed=1) == subs
    assert port_traces.split_trace(tr, 3, seed=2) != subs
    back = []
    for s in subs:
        p = str(tmp_path / f"shard{s['host']}.json")
        port_traces.save_trace(s, p)
        back.append(port_traces.load_trace(p))
    assert back == subs
    merged = port_traces.merge_traces(back)
    assert merged == tr
    assert len(port_stream.requests_from_trace(merged)) == len(
        port_stream.requests_from_trace(tr))
    assert port_traces.merge_traces(
        port_traces.split_trace(tr, 1, seed=0)) == tr
    with pytest.raises(ValueError):
        port_traces.merge_traces(subs[:2])
    # the reference shards the same trace the same way
    rtr = ref_traces.arrival_trace("bursty", n=23, seed=4,
                                   deadline_slack=(0.5, 2.0))
    assert json.loads(json.dumps(ref_traces.split_trace(rtr, 3, seed=1))) \
        == json.loads(json.dumps(subs))


# -- soak: seeded network-fault matrix ---------------------------------------

@pytest.mark.soak
def test_soak_fleet_chaos_matrix(tmp_path):
    """The fleet-chaos soak: a seeded drop/duplicate/partition schedule
    over the bursty trace, in both packages. Invariants: termination,
    exactly-once post-dedup emission of every request, and the
    reference's fleet counters. On failure the transport event log and
    undelivered-envelope table are the replay artifacts."""
    seed = int(os.environ.get("CHAOS_SEED", "0"))
    art_dir = os.environ.get("SOAK_ARTIFACT_DIR", str(tmp_path))

    def case(pkg):
        tr = pkg.traces.arrival_trace("bursty", n=32, seed=seed,
                                      budgets=(6, 10, 14),
                                      deadline_slack=(1.0, 6.0))
        ch = pkg.NetworkChaos(seed=seed, drop_rate=0.08, dup_rate=0.05,
                              reorder_rate=0.2, delay_max=2,
                              partition_at=[(12, "w0", ROUTER)],
                              heal_at=[(40, "*", "*")])
        rt = pkg.sim_fleet(pkg.requests_from_trace(tr), n_workers=3,
                           config=pkg.cold, n_lanes=4, chaos=ch, dt_s=0.05,
                           arrivals=tr["t"], request_timeout=16.0,
                           max_attempts=5, hb_timeout=60.0)
        seen = []
        rt.on_result = seen.append
        try:
            rt.run()
        finally:
            tag = f"{pkg.name}_"
            pkg.traces.save_trace(tr, os.path.join(
                art_dir, f"{tag}fleet_trace.json"))
            ch.save_events(os.path.join(art_dir,
                                        f"{tag}fleet_net_events.json"))
            with open(os.path.join(art_dir, f"{tag}fleet_undelivered.json"),
                      "w") as f:
                json.dump(rt.transport.undelivered_table(), f,
                          sort_keys=True)
        return rt, seen

    (rt, seen), (rrt, rseen) = _both(case)
    merged = dedup_results(seen)
    assert sorted(r.index for r in merged) == list(range(32))
    assert rt.fleet_stats() == rrt.fleet_stats()
    rmerged = ref_stream.dedup_results(rseen)
    _assert_level3([r.result for r in sorted(merged, key=lambda r: r.index)],
                   [r.result for r in sorted(rmerged,
                                             key=lambda r: r.index)])
