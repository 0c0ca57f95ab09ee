"""Overload-tolerant elastic serving on the port: elastic lane pools,
bounded-queue backpressure and failover routing. Mirrors
``tests/test_overload.py`` case for case, within the port as the
reference holds itself: an elastic run replay-matches the fixed-width
run bit for bit under cold fits (within ``WARM_TRACE_TOL`` warm), the
admission queue never exceeds ``max_pending``, every accepted request
emits exactly once, and ``"score"`` routing equals ``"rr"`` on a healthy
fleet, placement included.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.core.engine_config import EngineConfig
from repro_torch.distributed.sharding import (next_admission_shard,
                                              route_admission_shard)
from repro_torch.runtime.chaos import FaultInjector, SimulatedCrash
from repro_torch.runtime.stream import (StreamingBayesSplitEdge,
                                        dedup_results, requests_from_trace)
from repro_torch.wireless.traces import arrival_trace, save_trace

torch.set_num_threads(1)
CPU = dict(device="cpu")
COLD = EngineConfig(warm_start=False)
WARM = EngineConfig()
WARM_TRACE_TOL = 0.5                 # tests/test_overload.py's bound


def _reqs(n=8, budgets=(10, 14)):
    return [scenario_from_request("vgg19", (-1) ** i * 1.5,
                                  budgets[i % len(budgets)], i)
            for i in range(n)]


def _stream(feed, config=COLD, **kw):
    return StreamingBayesSplitEdge(feed, config, **CPU, **kw)


def _by_index(results):
    return {r.index: r for r in results}


def _assert_match(got, ref, bitwise=True, tol=WARM_TRACE_TOL):
    assert sorted(got) == sorted(ref), "request set mismatch (wedge?)"
    for i in ref:
        if bitwise:
            assert np.array_equal(
                np.asarray(got[i].result.utilities),
                np.asarray(ref[i].result.utilities)), f"request {i}"
            assert (got[i].result.best_utility
                    == ref[i].result.best_utility), f"request {i}"
        else:
            a = np.asarray(got[i].result.incumbent_trace)
            b = np.asarray(ref[i].result.incumbent_trace)
            m = min(a.size, b.size)
            assert np.max(np.abs(a[:m] - b[:m])) <= tol, f"request {i}"


@pytest.fixture(scope="module")
def fixed12():
    return _by_index(_stream(_reqs(12), n_lanes=2).serve())


@pytest.fixture(scope="module")
def sharded10():
    return _by_index(_stream(_reqs(10), n_lanes=8, n_shards=2,
                             routing="rr").serve())


# -- elastic pool sizing --------------------------------------------------------

def test_elastic_grow_replay_matches_fixed_cold(fixed12):
    eng = _stream(_reqs(12), n_lanes=2, elastic=True, n_lanes_min=2,
                  n_lanes_max=8)
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert st["n_grows"] >= 1, "feed never pressured the pool to grow"
    assert st["resize_log"]
    assert max(st["pool_widths"]) <= 8
    _assert_match(got, fixed12, bitwise=True)


def test_elastic_warm_within_tolerance_of_fixed():
    ref = _by_index(_stream(_reqs(10), WARM, n_lanes=2).serve())
    eng = _stream(_reqs(10), WARM, n_lanes=2, elastic=True, n_lanes_min=2,
                  n_lanes_max=8)
    got = _by_index(eng.serve())
    assert eng.stream_stats()["n_grows"] >= 1
    _assert_match(got, ref, bitwise=False)


def test_elastic_controller_hysteresis_and_cooldown():
    eng = _stream(_reqs(2), WARM, n_lanes=4, elastic=True, n_lanes_min=2,
                  n_lanes_max=16)
    p = eng._pools[0]
    assert p.width == 4
    eng._elastic_step(50)
    assert p.width == 4 and p.hot == 1
    eng._elastic_step(50)
    assert p.width == 8
    assert p.cool == eng.ELASTIC_COOLDOWN and p.hot == 0
    for _ in range(eng.ELASTIC_COOLDOWN):
        eng._elastic_step(50)
    assert p.width == 8
    eng._elastic_step(50)
    eng._elastic_step(50)
    assert p.width == 16
    eng._elastic_step(50)
    eng._elastic_step(50)
    assert p.width == 16
    p.cool = 0
    for _ in range(eng.ELASTIC_SHRINK_PATIENCE):
        eng._elastic_step(0)
    assert p.width == 2
    for _ in range(eng.ELASTIC_COOLDOWN + eng.ELASTIC_SHRINK_PATIENCE):
        eng._elastic_step(0)
    assert p.width == 2
    assert eng._counters["n_grows"] == 2 and eng._counters["n_shrinks"] == 1
    assert len(eng._resize_log) == 3


def test_elastic_resize_preserves_occupied_lanes():
    eng = _stream(_reqs(2), n_lanes=2)
    ref = _by_index(_stream(_reqs(2), n_lanes=2).serve())
    p = eng._pools[0]
    feed = _reqs(2)
    eng._requests = {0: feed[0], 1: feed[1]}
    p.admit([(0, feed[0]), (1, feed[1])])
    order0, gen0, ids0 = p.order.copy(), p.gen.copy(), p.lane_ids.copy()
    p.resize_to(8)
    assert p.width == 8
    np.testing.assert_array_equal(p.order[:2], order0)
    np.testing.assert_array_equal(p.order[2:], -1)
    np.testing.assert_array_equal(p.gen[:2], gen0)
    np.testing.assert_array_equal(p.gen[2:], 0)
    assert len(set(p.lane_ids.tolist())) == 8, "lane ids must not collide"
    assert not p.state["active"][2:].any()
    with pytest.raises(ValueError):
        p.resize_to(1)
    p.resize_to(2)
    np.testing.assert_array_equal(p.order, order0)
    np.testing.assert_array_equal(p.lane_ids, ids0)
    got = []
    while p.live_count() > 0:
        p.dispatch(draining=True)
        got += p.collect()[0]
    got += p.collect()[0]
    _assert_match(_by_index(got), ref, bitwise=True)


def test_elastic_geometry_roundtrips_through_resume(tmp_path, fixed12):
    ch = FaultInjector(seed=0, kill_at=[5])
    eng = _stream(_reqs(12), chaos=ch, n_lanes=2, elastic=True,
                  n_lanes_min=2, n_lanes_max=8, ckpt_dir=str(tmp_path),
                  ckpt_every=1)
    got = []
    with pytest.raises(SimulatedCrash):
        for r in eng.serve():
            got.append(r)
    grown = [p.width for p in eng._pools]
    resumed = StreamingBayesSplitEdge.resume(str(tmp_path), _reqs(12),
                                             config=COLD, **CPU)
    assert resumed.elastic and resumed.n_lanes_max == 8
    assert [p.width for p in resumed._pools] == grown
    got2 = list(resumed.serve())
    _assert_match(_by_index(dedup_results(got + got2)), fixed12,
                  bitwise=True)


def test_elastic_validation():
    with pytest.raises(ValueError, match="n_lanes_min"):
        _stream(_reqs(2), n_lanes=4, elastic=True, n_lanes_min=3,
                n_lanes_max=8)
    with pytest.raises(ValueError, match="n_lanes_min <= n_lanes"):
        _stream(_reqs(2), n_lanes=2, elastic=True, n_lanes_min=4,
                n_lanes_max=8)


# -- bounded admission queue ----------------------------------------------------

def _flood(n=10, budgets=(10, 12)):
    """n requests all arriving at t=0: the worst-case flash crowd."""
    return _reqs(n, budgets), [0.0] * n


@pytest.mark.parametrize("overload", ["block", "reject", "shed-oldest"])
def test_bounded_queue_holds_the_line(overload):
    feed, arrivals = _flood(10)
    eng = _stream(feed, WARM, n_lanes=2, arrivals=arrivals, max_pending=3,
                  overload=overload)
    got = list(eng.serve())
    st = eng.stream_stats()
    assert st["max_pending"] == 3
    assert st["queue_depth_max"] <= 3
    assert sorted(r.index for r in got) == list(range(10))
    if overload == "block":
        assert st["n_rejected"] == 0 and st["n_overflow_shed"] == 0
        assert not any(r.degraded for r in got)


def test_overload_reject_emits_degraded_results():
    feed, arrivals = _flood(10)
    eng = _stream(feed, WARM, n_lanes=2, arrivals=arrivals, max_pending=2,
                  overload="reject")
    got = list(eng.serve())
    st = eng.stream_stats()
    rejected = [r for r in got if r.degraded]
    assert st["n_rejected"] == len(rejected) >= 1
    assert all(r.reason == "rejected" and r.result.n_evals == 0
               for r in rejected)
    assert sorted(r.index for r in got) == list(range(10))


def test_overload_shed_oldest_prefers_hopeless():
    _, arrivals = _flood(10)
    feed = [scenario_from_request("vgg19", (-1) ** i * 1.5,
                                  (10, 12)[i % 2], i,
                                  deadline_s=(-1.0 if i in (0, 1) else 1e9))
            for i in range(10)]
    eng = _stream(feed, WARM, n_lanes=2, arrivals=arrivals, max_pending=2,
                  overload="shed-oldest")
    got = list(eng.serve())
    st = eng.stream_stats()
    assert st["queue_depth_max"] <= 2
    assert st["n_overflow_shed"] >= 1
    shed = [r for r in got if r.degraded]
    assert all(r.reason == "shed" for r in shed)
    assert {0, 1} <= {r.index for r in shed}
    assert sorted(r.index for r in got) == list(range(10))


def test_block_policy_is_pure_backpressure_no_loss():
    feed, arrivals = _flood(8)
    ref = _by_index(_stream(_reqs(8, (10, 12)), n_lanes=2,
                            arrivals=list(arrivals)).serve())
    got = _by_index(_stream(feed, n_lanes=2, arrivals=arrivals,
                            max_pending=2, overload="block").serve())
    _assert_match(got, ref, bitwise=True)


def test_max_pending_validation():
    with pytest.raises(ValueError, match="max_pending"):
        _stream(_reqs(2), n_lanes=2, max_pending=0)
    with pytest.raises(ValueError, match="overload"):
        _stream(_reqs(2), n_lanes=2, overload="panic")
    with pytest.raises(ValueError, match="routing"):
        _stream(_reqs(2), n_lanes=2, routing="magic")


# -- failover routing -----------------------------------------------------------

def test_route_healthy_fleet_reduces_to_most_free_rr():
    for free in ([3, 3, 3], [0, 2, 1], [1, 0, 0], [0, 0, 0],
                 [2, 2, 0], [5, 1, 5]):
        for rr in range(3):
            feats = [dict(free=f) for f in free]
            assert (route_admission_shard(feats, rr)
                    == next_admission_shard(free, rr)), (free, rr)


def test_route_skips_backoff_and_discounts_slow_stale():
    assert route_admission_shard(
        [dict(free=4, backoff=True), dict(free=1)], 0) == 1
    assert route_admission_shard(
        [dict(free=0), dict(free=3, backoff=True)], 0) is None
    assert route_admission_shard(
        [dict(free=2, ewma_wall_s=9.0), dict(free=2)], 0,
        wall_ref=1.0) == 1
    assert route_admission_shard(
        [dict(free=2, stale_frac=3.0), dict(free=2)], 0) == 1
    assert route_admission_shard(
        [dict(free=16, stale_frac=0.5), dict(free=1)], 0) == 0


def test_score_routing_matches_rr_on_healthy_fleet_end_to_end(sharded10):
    b = _by_index(_stream(_reqs(10), n_lanes=8, n_shards=2,
                          routing="score").serve())
    _assert_match(b, sharded10, bitwise=True)
    for i in sharded10:
        assert sharded10[i].pool == b[i].pool
        assert sharded10[i].lane == b[i].lane


def test_failover_ladder_drops_muted_pool_before_heartbeat_timeout(
        sharded10):
    ch = FaultInjector(seed=4, mute_pool_at=[2])
    eng = _stream(_reqs(10), n_lanes=8, n_shards=2, chaos=ch,
                  heartbeat_timeout_s=30.0, route_backoff_s=0.001,
                  route_max_retries=2)
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert st["n_backoffs"] >= 2
    assert st["n_rebalanced"] >= 1
    assert st["n_pool_drops"] == 1
    assert sorted(got) == list(range(10))
    _assert_match(got, sharded10, bitwise=True)


def test_flapping_pool_backs_off_and_recovers_without_drop():
    ch = FaultInjector(seed=4, flap_at=[2], flap_rounds=2)
    eng = _stream(_reqs(10), n_lanes=8, n_shards=2, chaos=ch,
                  heartbeat_timeout_s=30.0, route_backoff_s=0.2,
                  route_max_retries=50)
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert "flap" in [ev["kind"] for ev in ch.events]
    assert st["n_backoffs"] >= 1
    assert st["n_pool_drops"] == 0
    assert sorted(got) == list(range(10))


# -- soak: bursty overload at 4x nominal load -----------------------------------

@pytest.mark.soak
def test_soak_overload_bursty_4x(tmp_path):
    seed = int(os.environ.get("CHAOS_SEED", "0"))
    art_dir = os.environ.get("SOAK_ARTIFACT_DIR", str(tmp_path))
    tr = arrival_trace("bursty", n=60, seed=seed, budgets=(6, 10, 14),
                       deadline_slack=(1.0, 6.0), load=4.0)
    save_trace(tr, os.path.join(art_dir, "overload_trace.json"))
    stats = {}
    for label, elastic in (("fixed", False), ("elastic", True)):
        eng = _stream(requests_from_trace(tr), WARM, n_lanes=8,
                      arrivals=tr["t"], admission_policy="edf",
                      shed_hopeless=True, max_pending=16,
                      overload="shed-oldest", elastic=elastic,
                      n_lanes_min=4 if elastic else None,
                      n_lanes_max=32 if elastic else None)
        got = list(eng.serve())
        stats[label] = st = eng.stream_stats()
        assert sorted(r.index for r in got) == list(range(60)), label
        assert st["queue_depth_max"] <= 16, label
    assert stats["elastic"]["n_grows"] >= 1
    assert (stats["elastic"]["deadline_hit_rate"]
            >= stats["fixed"]["deadline_hit_rate"] - 0.25)
