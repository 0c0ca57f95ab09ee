"""Fault-injected streaming on the port (``repro_torch.runtime.chaos``):
mirrors ``tests/test_chaos.py`` case for case, and the frozen-bank
kill/resume case of ``tests/test_priorbank.py``.

Within the port, as the reference holds itself: recovery from every
injected fault class replay-matches the fault-free run bit for bit
under cold fits (kill/resume at rounds 2 and 4 after dedup, a NaN-poison
requeue, a pool drop, a delay) and within ``WARM_TRACE_TOL`` warm; no
fault class wedges the server.

Across packages (parity level 3): a cold stream checkpoint written by
the reference at kill round 2 resumes in the port, and one written by
the port resumes in the reference; either merged, deduped stream gives
the reference's uninterrupted answers (quantized accuracy, feasibility
and eval count equal, incumbent traces within one 1/64 quantum).
"""
import os

import numpy as np
import pytest
import torch

from repro.core.batch_bo import scenario_from_request as ref_request
from repro.runtime.chaos import FaultInjector as RefInjector
from repro.runtime.chaos import SimulatedCrash as RefCrash
from repro.runtime.stream import StreamingBayesSplitEdge as RefStream
from repro.runtime.stream import dedup_results as ref_dedup
from repro_torch.core import Scenario, default_vgg19_problem
from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.priorbank import PriorBank
from repro_torch.runtime.chaos import (FaultInjector, SimulatedCrash,
                                       load_events, poison_dataset,
                                       poison_theta)
from repro_torch.runtime.stream import (StreamingBayesSplitEdge,
                                        dedup_results, requests_from_trace)
from repro_torch.wireless.traces import arrival_trace, save_trace

torch.set_num_threads(1)
CPU = dict(device="cpu")
COLD = EngineConfig(warm_start=False)
WARM = EngineConfig()
QUANTUM = 100.0 / 64.0
WARM_TRACE_TOL = 0.5                 # tests/test_chaos.py's bound


def _reqs(n=8, budgets=(6, 8, 10), request=scenario_from_request):
    return [request("vgg19", (-1) ** i * 1.5, budgets[i % len(budgets)], i)
            for i in range(n)]


def _stream(feed, config=COLD, **kw):
    return StreamingBayesSplitEdge(feed, config, **CPU, **kw)


def _by_index(results):
    return {r.index: r for r in results}


def _assert_match(got, ref, bitwise=True, tol=WARM_TRACE_TOL):
    assert sorted(got) == sorted(ref), "request set mismatch (wedge?)"
    for i in ref:
        a = np.asarray(got[i].result.incumbent_trace)
        b = np.asarray(ref[i].result.incumbent_trace)
        if bitwise:
            assert np.array_equal(
                np.asarray(got[i].result.utilities),
                np.asarray(ref[i].result.utilities)), f"request {i}"
            assert (got[i].result.best_utility
                    == ref[i].result.best_utility), f"request {i}"
        else:
            assert np.max(np.abs(a - b)) <= tol, f"request {i}"


@pytest.fixture(scope="module")
def ref16():
    return _by_index(_stream(_reqs(16), n_lanes=4).serve())


@pytest.fixture(scope="module")
def ref10_14():
    return _by_index(_stream(_reqs(10, (14,)), n_lanes=4).serve())


@pytest.fixture(scope="module")
def ref10_sharded():
    return _by_index(_stream(_reqs(10), n_lanes=8, n_shards=2).serve())


# -- checkpoint / restore -----------------------------------------------------

def _killed(tmp_path, kill_at, feed, **kw):
    ch = FaultInjector(seed=0, kill_at=[kill_at])
    eng = _stream(feed, chaos=ch, ckpt_dir=str(tmp_path), ckpt_every=1,
                  **kw)
    got = []
    with pytest.raises(SimulatedCrash):
        for r in eng.serve():
            got.append(r)
    assert ch.events[-1]["kind"] == "kill"
    return got


@pytest.mark.parametrize("kill_at", [2, 4])
def test_kill_resume_replay_match(tmp_path, kill_at, ref16):
    got = _killed(tmp_path, kill_at, _reqs(16), n_lanes=4)
    resumed = StreamingBayesSplitEdge.resume(str(tmp_path), _reqs(16),
                                             config=COLD, **CPU)
    got2 = list(resumed.serve())
    merged = _by_index(dedup_results(got + got2))
    _assert_match(merged, ref16, bitwise=True)


def test_resume_requires_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        StreamingBayesSplitEdge.resume(str(tmp_path / "empty"), _reqs(),
                                       **CPU)


def test_resume_rejects_static_shape_mismatch(tmp_path):
    eng = _stream(_reqs(), WARM, n_lanes=8, n_shards=2,
                  ckpt_dir=str(tmp_path), ckpt_every=0)
    list(eng.serve())
    eng.checkpoint_now()
    with pytest.raises(ValueError, match="n_shards"):
        StreamingBayesSplitEdge.resume(str(tmp_path), _reqs(), n_shards=1,
                                       n_lanes=8, **CPU)


def test_checkpoint_now_and_counters(tmp_path):
    eng = _stream(_reqs(4), WARM, n_lanes=4, ckpt_dir=str(tmp_path),
                  ckpt_every=2)
    list(eng.serve())
    assert eng.stream_stats()["n_checkpoints"] >= 1
    assert os.path.isdir(str(tmp_path))


def test_kill_resume_with_frozen_bank_replay_matches(tmp_path):
    """Crash under a warm FROZEN bank, resume with the same bank: the
    merged deduped stream is bitwise the uninterrupted run."""
    def reqs():
        return [Scenario(default_vgg19_problem(), seed=s, budget=b)
                for s in (0, 1, 2) for b in (6, 8)]

    bank = PriorBank()
    _stream(reqs(), n_lanes=2, bank=bank).run()
    bank.freeze()
    ref = _by_index(_stream(reqs(), n_lanes=2, bank=bank).serve())
    got = _killed(tmp_path, 2, reqs(), n_lanes=2, bank=bank)
    resumed = StreamingBayesSplitEdge.resume(str(tmp_path), reqs(),
                                             config=COLD, bank=bank, **CPU)
    got += list(resumed.serve())
    _assert_match(_by_index(dedup_results(got)), ref, bitwise=True)


# -- checkpoints across packages ----------------------------------------------

@pytest.fixture(scope="module")
def reference16():
    return _by_index(RefStream(_reqs(16, request=ref_request), n_lanes=4,
                               warm_start=False).serve())


def _assert_reference_answers(merged, ref):
    assert sorted(merged) == sorted(ref) == list(range(16))
    for i in ref:
        g, r = merged[i].result, ref[i].result
        assert g.best_accuracy == r.best_accuracy, i
        assert (g.best_a is None) == (r.best_a is None), i
        assert g.n_evals == r.n_evals, i
        np.testing.assert_allclose(g.incumbent_trace, r.incumbent_trace,
                                   atol=QUANTUM)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, reference16):
    ch = RefInjector(seed=0, kill_at=[2])
    eng = RefStream(_reqs(16, request=ref_request), n_lanes=4,
                    warm_start=False, chaos=ch, ckpt_dir=str(tmp_path),
                    ckpt_every=1)
    got = []
    with pytest.raises(RefCrash):
        for r in eng.serve():
            got.append(r)
    resumed = StreamingBayesSplitEdge.resume(str(tmp_path), _reqs(16),
                                             config=COLD, **CPU)
    assert resumed._round == 2
    got += list(resumed.serve())
    _assert_reference_answers(_by_index(dedup_results(got)), reference16)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, reference16):
    got = _killed(tmp_path, 2, _reqs(16), n_lanes=4)
    resumed = RefStream.resume(str(tmp_path), _reqs(16, request=ref_request),
                               warm_start=False)
    got += list(resumed.serve())
    _assert_reference_answers(_by_index(ref_dedup(got)), reference16)


# -- divergence quarantine ----------------------------------------------------

def test_poisons_write_no_tensor_in_place():
    y = torch.zeros(4, 3)
    theta = dict(log_ls=torch.zeros(4), log_sv=torch.ones(4))
    st = dict(y=y, theta=theta)
    p = poison_dataset(st, 2)
    assert torch.isnan(p["y"][2]).all() and not torch.isnan(y).any()
    assert not torch.isnan(p["y"][[0, 1, 3]]).any()
    q = poison_theta(st, 1)
    assert all(torch.isnan(v[1]) and not torch.isnan(v[[0, 2, 3]]).any()
               for v in q["theta"].values())
    assert not torch.isnan(theta["log_ls"]).any() and q["y"] is y


def test_nan_poison_requeue_cold_bitwise(ref10_14):
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    eng = _stream(_reqs(10, (14,)), n_lanes=4, chaos=ch)
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert any(ev["kind"] == "nan_poison" for ev in ch.events)
    assert st["n_faults"] >= 1 and st["n_requeued"] >= 1
    assert st["n_degraded"] == 0
    _assert_match(got, ref10_14, bitwise=True)


def test_nan_poison_of_the_chunk_s_first_lane_faults_only_it(ref10_14):
    """``_by_width`` pads a short chunk with copies of its first lane;
    poisoning that lane faults it alone, and the requeue still
    replay-matches."""
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    ch._pick_lane = lambda pool: 0
    eng = _stream(_reqs(10, (14,)), n_lanes=4, chaos=ch)
    got = _by_index(eng.serve())
    ev = next(e for e in ch.events if e["kind"] == "nan_poison")
    assert ev["lane"] == 0
    assert eng.stream_stats()["n_faults"] == 1
    _assert_match(got, ref10_14, bitwise=True)


def test_nan_poison_warm_within_tolerance():
    ref = _by_index(_stream(_reqs(10, (14,)), WARM, n_lanes=4).serve())
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    got = _by_index(_stream(_reqs(10, (14,)), WARM, n_lanes=4,
                            chaos=ch).serve())
    _assert_match(got, ref, bitwise=False)


def test_repair_ladder_in_place():
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    eng = _stream(_reqs(10, (14,)), WARM, n_lanes=4, chaos=ch,
                  quarantine="repair")
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert sorted(got) == list(range(10))
    assert st["n_requeued"] == 0
    assert st["n_faults"] >= 2


def test_quarantine_terminal_rung_degrades_not_wedges():
    ch = FaultInjector(seed=1, nan_poison_at=[2])
    eng = _stream(_reqs(10, (14,)), WARM, n_lanes=4, chaos=ch)
    eng._rungs = ("retire",)
    got = _by_index(eng.serve())
    st = eng.stream_stats()
    assert sorted(got) == list(range(10))
    deg = [r for r in got.values() if r.degraded]
    assert len(deg) == 1 and deg[0].reason == "quarantine"
    assert st["n_degraded"] == 1
    assert deg[0].result.n_evals >= 0


def test_theta_poison_strict_detection():
    ch = FaultInjector(seed=1, nan_poison_at=[2], poison="theta")
    eng = _stream(_reqs(10, (14,)), WARM, n_lanes=4, chaos=ch,
                  fault_on_divergence=True)
    got = _by_index(eng.serve())
    assert sorted(got) == list(range(10))
    assert eng.stream_stats()["n_faults"] >= 1


# -- pool loss ----------------------------------------------------------------

def test_pool_drop_requeues_onto_survivor(ref10_sharded):
    ch = FaultInjector(seed=2, drop_pool_at=[2])
    eng = _stream(_reqs(10), n_lanes=8, n_shards=2, chaos=ch)
    got = _by_index(eng.serve())
    assert eng.stream_stats()["n_pool_drops"] == 1
    assert any(ev["kind"] == "drop_pool" for ev in ch.events)
    _assert_match(got, ref10_sharded, bitwise=True)


def test_all_pools_lost_raises():
    ch = FaultInjector(seed=3, drop_pool_at=[2])
    eng = _stream(_reqs(10), WARM, n_lanes=4, n_shards=1, chaos=ch)
    with pytest.raises(RuntimeError, match="all lane pools lost"):
        list(eng.serve())


def test_heartbeat_detects_muted_pool():
    ch = FaultInjector(seed=4, mute_pool_at=[2])
    eng = _stream(_reqs(10), WARM, n_lanes=8, n_shards=2, chaos=ch,
                  heartbeat_timeout_s=0.3)
    got = _by_index(eng.serve())
    assert sorted(got) == list(range(10))
    assert eng.stream_stats()["n_pool_drops"] == 1


# -- deadlines ----------------------------------------------------------------

def test_deadline_free_edf_is_fifo_bitwise():
    a = _by_index(_stream(_reqs(10), n_lanes=4,
                          admission_policy="fifo").serve())
    b = _by_index(_stream(_reqs(10), n_lanes=4,
                          admission_policy="edf").serve())
    _assert_match(b, a, bitwise=True)
    for i in a:
        assert a[i].pool == b[i].pool and a[i].lane == b[i].lane


def test_hopeless_requests_shed_degraded_exactly_once():
    reqs = [scenario_from_request("vgg19", 0.0, 8, i, deadline_s=-1.0)
            for i in range(6)]
    eng = _stream(reqs, WARM, n_lanes=4, shed_hopeless=True)
    got = list(eng.serve())
    st = eng.stream_stats()
    assert sorted(r.index for r in got) == list(range(6))
    assert all(r.degraded and r.reason == "shed" for r in got)
    assert all(r.result.n_evals == 0 for r in got)
    assert st["n_shed"] == 6 and st["n_dispatches"] == 0
    assert st["deadline_hit_rate"] == 0.0


def test_mixed_deadlines_no_wedge_and_custom_policy():
    tr = arrival_trace("bursty", n=16, seed=0, budgets=(6, 10),
                       deadline_slack=(0.5, 3.0))
    eng = _stream(requests_from_trace(tr), WARM, n_lanes=4,
                  arrivals=tr["t"], admission_policy="edf",
                  shed_hopeless=True)
    got = list(eng.serve())
    assert sorted(r.index for r in got) == list(range(16))
    assert 0.0 <= eng.stream_stats()["deadline_hit_rate"] <= 1.0
    eng2 = _stream(_reqs(6), WARM, n_lanes=4,
                   admission_policy=lambda pending, now: list(
                       range(len(pending)))[::-1])
    assert sorted(r.index for r in eng2.serve()) == list(range(6))


# -- chaos event log: determinism, JSON round-trip, replay ---------------------

def test_delay_event_logged_and_harmless():
    ref = _by_index(_stream(_reqs(6), n_lanes=4).serve())
    ch = FaultInjector(seed=5, delay_at=[2], delay_s=0.01)
    got = _by_index(_stream(_reqs(6), n_lanes=4, chaos=ch).serve())
    evs = [ev for ev in ch.events if ev["kind"] == "delay"]
    assert len(evs) == 1
    assert evs[0]["round"] == 2 and evs[0]["delay_s"] == 0.01
    assert "pool" in evs[0]
    _assert_match(got, ref, bitwise=True)


def test_storm_event_floods_the_pull():
    tr = arrival_trace("poisson", n=12, seed=0, budgets=(6, 10),
                       rate_hz=5.0)
    ch = FaultInjector(seed=6, storm_at=[2], storm_n=6)
    eng = _stream(requests_from_trace(tr), WARM, n_lanes=4,
                  arrivals=tr["t"], time_scale=0.05, chaos=ch)
    got = list(eng.serve())
    evs = [ev for ev in ch.events if ev["kind"] == "storm"]
    assert len(evs) == 1 and evs[0]["n"] >= 1
    lo = evs[0]["first"]
    assert all(t == 0.0 for t in eng.arrivals[lo:lo + evs[0]["n"]])
    assert sorted(r.index for r in got) == list(range(12))


def test_storm_without_arrivals_is_skipped():
    ch = FaultInjector(seed=6, storm_at=[1])
    list(_stream(_reqs(4), WARM, n_lanes=4, chaos=ch).serve())
    assert any(ev["kind"] == "storm_skipped" for ev in ch.events)


def test_flap_event_mutes_then_unmutes():
    ch = FaultInjector(seed=4, flap_at=[2], flap_rounds=2)
    got = _by_index(_stream(_reqs(10), n_lanes=8, n_shards=2, chaos=ch,
                            heartbeat_timeout_s=30.0,
                            route_max_retries=50).serve())
    kinds = [ev["kind"] for ev in ch.events]
    assert "flap" in kinds
    flap = next(ev for ev in ch.events if ev["kind"] == "flap")
    assert flap["until"] == flap["round"] + 2
    if "unflap" in kinds:
        unflap = next(ev for ev in ch.events if ev["kind"] == "unflap")
        assert unflap["pool"] == flap["pool"]
        assert unflap["round"] >= flap["until"]
    assert sorted(got) == list(range(10))


def test_slow_pool_event_slows_dispatches():
    ch = FaultInjector(seed=7, slow_pool_at=[2], slow_s=0.005,
                       slow_rounds=3)
    got = _by_index(_stream(_reqs(10), n_lanes=8, n_shards=2,
                            chaos=ch).serve())
    evs = [ev for ev in ch.events if ev["kind"] == "slow_pool"]
    assert len(evs) == 1
    assert evs[0]["until"] == evs[0]["round"] + 3
    assert evs[0]["slow_s"] == 0.005
    assert sorted(got) == list(range(10))


def test_event_log_roundtrips_and_replays(tmp_path):
    def one_run():
        ch = FaultInjector(seed=9, delay_at=[2], flap_at=[3],
                           slow_pool_at=[4], flap_rounds=2, slow_s=0.001)
        got = _by_index(_stream(_reqs(12), n_lanes=8, n_shards=2,
                                chaos=ch).serve())
        return ch, got

    ch1, got1 = one_run()
    ch2, got2 = one_run()
    assert ch1.events == ch2.events, "chaos schedule must be seed-pure"
    assert sorted(got1) == sorted(got2) == list(range(12))
    for i in got1:
        assert got1[i].pool == got2[i].pool, f"request {i} placement"
    _assert_match(got2, got1, bitwise=True)
    path = str(tmp_path / "events.json")
    ch1.save_events(path)
    back = load_events(path)
    assert back["seed"] == 9
    assert back["events"] == ch1.events


# -- soak: seeded fault matrix ------------------------------------------------

@pytest.mark.soak
def test_soak_chaos_matrix(tmp_path):
    seed = int(os.environ.get("CHAOS_SEED", "0"))
    art_dir = os.environ.get("SOAK_ARTIFACT_DIR", str(tmp_path))
    tr = arrival_trace("bursty", n=40, seed=seed, budgets=(6, 10, 14),
                       deadline_slack=(1.0, 6.0))
    save_trace(tr, os.path.join(art_dir, "chaos_trace.json"))
    ch = FaultInjector(seed=seed, nan_poison_at=[3], drop_pool_at=[5],
                       kill_at=[7])
    eng = _stream(requests_from_trace(tr), WARM, n_lanes=8, n_shards=2,
                  admission_policy="edf", shed_hopeless=True, chaos=ch,
                  ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    got = []
    try:
        for r in eng.serve():
            got.append(r)
    except SimulatedCrash:
        resumed = StreamingBayesSplitEdge.resume(
            str(tmp_path / "ckpt"), requests_from_trace(tr),
            admission_policy="edf", shed_hopeless=True, **CPU)
        got += list(resumed.serve())
    finally:
        ch.save_events(os.path.join(art_dir, "chaos_events.json"))
    merged = dedup_results(got)
    assert sorted(r.index for r in merged) == list(range(40))
