"""The port's streaming server (``repro_torch.runtime.stream``) on the CPU.

Mirrors ``tests/test_streaming.py`` case for case, and the streaming
cases of ``test_priorbank.py``, ``test_surrogate.py``,
``test_checkpoint.py`` and ``test_lm_scenarios.py``, each held within
the port as the reference holds itself: a cold stream equals the
uncompacted whole run bit for bit (results and ledger rows), admission
order, ``budget_max`` padding and sharding are invisible, an empty
frozen bank equals no bank; warm streams stay within
``WARM_TRACE_TOL`` of the warm compacted whole run with equal eval
counts and accuracies.

Across packages (parity level 3): the LM blend through 8 lanes gives
the reference's quantized accuracy, feasibility and eval count per
request, incumbent traces within one 1/64 quantum. The hetero mix and the
mixed trace are held to the reference in
``tests/test_torch_stream_answers.py``.

``admit_init``'s seed fit runs on ``LANE_WIDTH`` chunks: a lane's seeded
hyperparameters and fit steps are the same bits whatever the admission's
size, cold-seeded and bank-hit warm.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import WholeRunBayesSplitEdge as RefWholeRun
from repro.core import make_hetero_scenarios as ref_hetero
from repro.runtime.stream import StreamingBayesSplitEdge as RefStream
from repro.wireless.traces import MIXED_TRACE_ARCHS as REF_MIXED
from repro_torch.checkpoint import latest_step, load_manifest
from repro_torch.core import (BatchedBayesSplitEdge, Scenario,
                              WholeRunBayesSplitEdge, default_vgg19_problem,
                              make_hetero_scenarios, make_mixed_scenarios)
from repro_torch.core import surrogate as smod
from repro_torch.core import wholerun as wr
from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.priorbank import PriorBank
from repro_torch.runtime.stream import (StreamingBayesSplitEdge, StreamResult,
                                        dedup_results, requests_from_trace)
from repro_torch.wireless.traces import (MIXED_TRACE_ARCHS, arrival_trace,
                                         load_trace, save_trace)

torch.set_num_threads(1)
CPU = dict(device="cpu")
COLD = EngineConfig(warm_start=False)
COLD_U = EngineConfig(warm_start=False, compact=False)
QUANTUM = 100.0 / 64.0               # one accuracy quantum (level 3)
COLD_TRACE_TOL = 1e-4                # tests/test_streaming.py's bounds
WARM_TRACE_TOL = 0.5


def _stream(feed, config=COLD, **kw):
    return StreamingBayesSplitEdge(feed, config, **CPU, **kw)


def _vgg(seeds=(0, 1), budgets=(6, 10, 12)):
    return [Scenario(default_vgg19_problem(), seed=s, budget=b)
            for s in seeds for b in budgets]


def _assert_bitwise(res_a, res_b):
    assert len(res_a) == len(res_b)
    for a, b in zip(res_a, res_b):
        assert a.n_evals == b.n_evals
        assert a.utilities == b.utilities
        assert a.accuracies == b.accuracies
        assert a.incumbent_trace == b.incumbent_trace
        assert a.feasible == b.feasible
        assert a.best_accuracy == b.best_accuracy
        assert a.best_utility == b.best_utility
        assert np.array_equal(a.best_a, b.best_a)


def _trace_div(r1, r2):
    m = min(r1.n_evals, r2.n_evals)
    return float(np.max(np.abs(np.asarray(r1.incumbent_trace[:m])
                               - np.asarray(r2.incumbent_trace[:m]))))


# ---------------------------------------------------------------------------
# replay equivalence: streaming == one offline batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hetero_offline():
    eng = WholeRunBayesSplitEdge(make_hetero_scenarios(), COLD_U, **CPU)
    return eng.run(), eng._last_raw


def test_stream_cold_bitwise_matches_offline_batch(hetero_offline):
    """16 heterogeneous requests through an 8-lane server, cold fits:
    bit for bit the uncompacted whole run, results and every ledger
    row the flush snapshots."""
    res_o, raw_o = hetero_offline
    flushed = []
    eng = _stream(make_hetero_scenarios(), n_lanes=8,
                  on_result=flushed.append)
    _assert_bitwise(eng.run(), res_o)
    assert len(flushed) == 16
    for r in flushed:
        for k in wr._OUT_KEYS:
            if k != "gen":        # the lane's generation is the stream's
                assert r.raw[k].tobytes() == raw_o[k][r.index].tobytes(), k
    st = eng.stream_stats()
    # the reference's lane log of this mix (BENCH_bo_engine.json)
    assert [(e["lanes"], e["live"], e["bucket"], e["iters"])
            for e in st["lane_log"]] == [(8, 6, 16, 1), (8, 6, 16, 1),
                                         (8, 8, 16, 5), (4, 4, 16, 4),
                                         (2, 2, 16, 2)]
    # every acquisition iteration computes one padded LANE_WIDTH chunk
    assert st["acq_chunks"] == st["acq_iters"] == 13


def test_stream_warm_within_tolerance_of_offline():
    r_s = _stream(make_hetero_scenarios(), EngineConfig(), n_lanes=8).run()
    r_o = WholeRunBayesSplitEdge(make_hetero_scenarios(), **CPU).run()
    for a, b in zip(r_s, r_o):
        assert a.n_evals == b.n_evals
        assert a.best_accuracy == b.best_accuracy
        assert _trace_div(a, b) < WARM_TRACE_TOL


@pytest.fixture(scope="module")
def vgg_offline():
    return WholeRunBayesSplitEdge(_vgg(), COLD_U, **CPU).run()


def test_admission_order_permutation_invariant(vgg_offline):
    perm = [3, 0, 5, 2, 4, 1]
    r_a = _stream(_vgg(), n_lanes=2, budget_max=12).run()
    r_b = _stream([_vgg()[i] for i in perm], n_lanes=2,
                  budget_max=12).run()
    r_b_orig = [None] * len(perm)
    for j, i in enumerate(perm):
        r_b_orig[i] = r_b[j]
    _assert_bitwise(r_a, r_b_orig)
    _assert_bitwise(r_a, vgg_offline)


def test_stream_budget_max_padding_is_invisible(vgg_offline):
    r_s = _stream(_vgg(), n_lanes=2, budget_max=20).run()
    _assert_bitwise(r_s, vgg_offline)


def test_stream_single_lane_serves_sequentially():
    r_s = _stream(_vgg(seeds=(0,)), n_lanes=1, budget_max=12).run()
    r_o = WholeRunBayesSplitEdge(_vgg(seeds=(0,)), COLD_U, **CPU).run()
    _assert_bitwise(r_s, r_o)


def test_stream_lanes_exceed_requests():
    scs = _vgg(seeds=(0,), budgets=(6, 10))
    r_s = _stream(_vgg(seeds=(0,), budgets=(6, 10)), n_lanes=8, l_pad=37,
                  budget_max=12).run()
    r_o = WholeRunBayesSplitEdge(scs, COLD_U, **CPU).run()
    for a, b in zip(r_s, r_o):
        assert a.n_evals == b.n_evals
        assert a.utilities == b.utilities


def test_stream_mixed_arch_composes():
    """VGG19 + ResNet101 requests (max-L padded lanes) against the
    batched engine, within the reference's cold trace bound."""
    res_s = _stream(make_mixed_scenarios(), n_lanes=2, budget_max=16).run()
    res_b = BatchedBayesSplitEdge(make_mixed_scenarios(), **CPU).run()
    for a, b in zip(res_s, res_b):
        assert a.n_evals == b.n_evals
        assert a.best_accuracy == b.best_accuracy
        assert _trace_div(a, b) < COLD_TRACE_TOL


def test_stream_empty_feed():
    assert _stream([], n_lanes=2).run() == []


# ---------------------------------------------------------------------------
# lane generations: re-admitted lanes never inherit stale ledger rows
# ---------------------------------------------------------------------------


def test_readmitted_lane_ledger_never_mixes_generations():
    results = []
    _stream(_vgg(), n_lanes=2, budget_max=12,
            on_result=results.append).run()
    assert len(results) == 6
    by_lane: dict = {}
    for r in results:
        assert isinstance(r, StreamResult)
        n = r.result.n_evals
        ls = r.raw["ev_l"]
        assert int(r.raw["n"]) == n
        assert np.all(ls[:n] >= 1)
        assert np.all(ls[n:] == -1)
        assert int(r.raw["gen"]) == r.gen
        by_lane.setdefault((r.pool, r.lane), []).append(r)
    assert any(len(v) > 1 for v in by_lane.values())
    for v in by_lane.values():
        gens = [r.gen for r in v]
        assert len(set(gens)) == len(gens)
        assert gens == sorted(gens)


def test_stream_ledger_rows_match_offline_per_scenario():
    results = []
    _stream(_vgg(), n_lanes=2, budget_max=12,
            on_result=results.append).run()
    eng_o = WholeRunBayesSplitEdge(_vgg(), COLD_U, **CPU)
    eng_o.run()
    raw_o = eng_o._last_raw
    for r in results:
        i = r.index
        n = int(raw_o["n"][i])
        assert r.result.n_evals == n
        np.testing.assert_array_equal(r.raw["ev_l"][:n],
                                      raw_o["ev_l"][i][:n])
        np.testing.assert_array_equal(r.raw["ev_u"][:n],
                                      raw_o["ev_u"][i][:n])


# ---------------------------------------------------------------------------
# serving surface: admission control, callbacks, laziness, stats
# ---------------------------------------------------------------------------


def test_request_over_budget_max_rejected():
    eng = _stream([Scenario(default_vgg19_problem(), budget=30)],
                  EngineConfig(), n_lanes=1, budget_max=20, l_pad=37)
    res = list(eng.serve())
    assert len(res) == 1
    assert res[0].degraded and res[0].reason == "rejected"
    assert res[0].result.n_evals == 0
    assert eng.stream_stats()["n_rejected"] == 1


def test_request_arch_exceeding_l_pad_rejected():
    eng = _stream([Scenario(default_vgg19_problem(), budget=10)],
                  EngineConfig(), n_lanes=1, budget_max=12, l_pad=20)
    res = list(eng.serve())
    assert len(res) == 1
    assert res[0].degraded and res[0].reason == "rejected"
    assert res[0].result.n_evals == 0


def test_iterator_feed_requires_static_shapes():
    with pytest.raises(ValueError):
        _stream(iter(_vgg()), n_lanes=2)


def test_lane_counts_must_split_over_shards():
    with pytest.raises(ValueError):
        _stream(_vgg(), n_lanes=4, n_shards=3)


def test_results_in_arrival_order_and_completion_callback():
    seen = []
    scs = _vgg(seeds=(0,), budgets=(6, 12, 10))
    eng = _stream(_vgg(seeds=(0,), budgets=(6, 12, 10)), n_lanes=2,
                  budget_max=12, on_result=seen.append)
    res = eng.run()
    assert len(res) == len(scs)
    assert sorted(r.index for r in seen) == list(range(len(scs)))
    for r in seen:
        assert res[r.index] is r.result
    assert seen[0].index == 0


def test_generator_feed_consumed_lazily():
    pulled = []

    def feed():
        for sc in _vgg():
            pulled.append(len(pulled))
            yield sc

    eng = _stream(feed(), n_lanes=2, l_pad=37, budget_max=12)
    it = eng.serve()
    first = next(it)
    assert len(pulled) <= 2 + eng.n_lanes + 1
    assert first.result.n_evals >= 1
    assert len(list(it)) == 5


def test_serve_is_single_shot():
    eng = _stream(_vgg(seeds=(0,), budgets=(6,)), EngineConfig(),
                  n_lanes=1, budget_max=6)
    eng.run()
    with pytest.raises(RuntimeError):
        next(eng.serve())


def test_stream_stats_accounting():
    eng = _stream(_vgg(), n_lanes=2, budget_max=12)
    res = eng.run()
    st = eng.stream_stats()
    assert st["n_results"] == len(res) == 6
    assert st["n_dispatches"] >= 1
    assert 0.0 < st["occupancy_mean"] <= 1.0
    assert st["lane_slots"] >= st["loop_evals"]
    assert st["loop_evals"] == sum(r.n_evals for r in res) - 9 * len(res)
    assert st["queue_depth_max"] >= 0
    assert st["arrivals_per_s"] > 0
    for e in st["lane_log"]:
        assert set(e) >= {"pool", "lanes", "live", "bucket", "iters",
                          "queue_depth", "acq_iters", "chunks"}
        assert e["chunks"] == 1 and e["acq_iters"] <= e["iters"]
    assert st["acq_chunks"] == st["acq_iters"] == sum(
        e["acq_iters"] for e in st["lane_log"])
    assert st["host_reads"] >= st["n_dispatches"]


def test_wide_pool_pays_a_chunk_per_16_lanes():
    """A 32-lane pool computes two LANE_WIDTH chunks an acquisition
    iteration, and gives the 8-lane pool's answers bit for bit."""
    scs = _vgg(seeds=(0, 1, 2, 3, 4, 5), budgets=(10, 12))
    eng = _stream(scs, n_lanes=32, budget_max=12)
    r_w = eng.run()
    st = eng.stream_stats()
    assert st["lane_log"][0]["lanes"] == 32
    assert st["lane_log"][0]["chunks"] == 2
    assert st["acq_chunks"] == sum(e["acq_iters"] * e["chunks"]
                                   for e in st["lane_log"])
    _assert_bitwise(r_w, _stream(scs, n_lanes=8, budget_max=12).run())


# ---------------------------------------------------------------------------
# sharded pools: per-shard admission, zero collectives
# ---------------------------------------------------------------------------


def test_sharded_pools_cold_bitwise_matches_single_pool():
    r_1 = _stream(_vgg(), n_lanes=4, n_shards=1, budget_max=12).run()
    r_2 = _stream(_vgg(), n_lanes=4, n_shards=2, budget_max=12).run()
    _assert_bitwise(r_2, r_1)


def test_sharded_pool_with_no_admissions_survives_drain():
    res = _stream([Scenario(default_vgg19_problem(), budget=12)],
                  n_lanes=4, n_shards=2, budget_max=12).run()
    assert len(res) == 1
    assert res[0].n_evals == 12


def test_sharded_pools_spread_admissions():
    results = []
    _stream(_vgg(), n_lanes=4, n_shards=2, budget_max=12,
            on_result=results.append).run()
    assert sorted({r.pool for r in results}) == [0, 1]


def test_shards_on_named_devices():
    """``devices=`` pins each shard's pool to a torch device."""
    eng = _stream(_vgg(seeds=(0,)), n_lanes=4, n_shards=2, budget_max=12,
                  devices=["cpu", torch.device("cpu")])
    assert [p.device for p in eng._pools] == [torch.device("cpu")] * 2
    assert len(eng.run()) == 3


# ---------------------------------------------------------------------------
# arrival traces: replay determinism + soak
# ---------------------------------------------------------------------------


def test_trace_replay_is_deterministic():
    tr = arrival_trace("poisson", n=6, seed=3, budgets=(6, 10),
                       archs=("vgg19",))
    r_1 = _stream(requests_from_trace(tr), n_lanes=2, budget_max=10).run()
    r_2 = _stream(requests_from_trace(tr), n_lanes=2, budget_max=10).run()
    _assert_bitwise(r_1, r_2)


def test_trace_roundtrips_through_json(tmp_path):
    tr = arrival_trace("bursty", n=12, seed=1)
    p = str(tmp_path / "trace.json")
    save_trace(tr, p)
    assert load_trace(p) == tr


def test_requests_from_trace_decodes_fields():
    tr = arrival_trace("replay", n=8, seed=0, budgets=(6, 10),
                       archs=("vgg19", "resnet101"))
    reqs = requests_from_trace(tr)
    assert len(reqs) == 8
    for sc, arch, budget in zip(reqs, tr["arch"], tr["budget"]):
        assert sc.budget == budget
        assert sc.problem.L == (37 if arch == "vgg19" else 36)
    base = scenario_from_request("vgg19").problem.gain_db
    assert any(abs(sc.problem.gain_db - base) > 1e-6
               for sc in reqs if sc.problem.L == 37)


@pytest.mark.slow
@pytest.mark.soak
def test_soak_100_arrivals_through_8_lanes(tmp_path):
    tr = arrival_trace("poisson", n=100, seed=7, budgets=(6, 8, 10, 12),
                       archs=("vgg19", "resnet101"))
    art_dir = os.environ.get("SOAK_ARTIFACT_DIR", str(tmp_path))
    save_trace(tr, os.path.join(art_dir, "soak_trace.json"))
    results = []
    eng = _stream(requests_from_trace(tr), EngineConfig(), n_lanes=8,
                  budget_max=12, arrivals=tr["t"], time_scale=0.05,
                  on_result=results.append)
    out = eng.run()
    assert len(out) == 100
    st = eng.stream_stats()
    assert st["n_results"] == 100
    assert 0.0 < st["occupancy_mean"] <= 1.0
    assert len({(r.pool, r.lane) for r in results}) <= 8
    for r in results:
        res, sc = r.result, r.scenario
        assert 1 <= res.n_evals <= sc.budget or res.n_evals == 9
        ls = r.raw["ev_l"][:res.n_evals]
        assert ls.min() >= 1 and ls.max() <= sc.problem.L
        assert np.all(r.raw["ev_l"][res.n_evals:] == -1)
    assert sum(1 for r in results if r.gen > 0) >= 100 - 8


# ---------------------------------------------------------------------------
# the prior bank, surrogates, config and checkpoints on the stream
# ---------------------------------------------------------------------------


def _scens(seeds=(0, 1), budgets=(6, 8)):
    return [Scenario(default_vgg19_problem(), seed=s, budget=b)
            for s in seeds for b in budgets]


def test_stream_frozen_empty_bank_bitwise():
    base = _stream(_scens(), n_lanes=2).run()
    fb = _stream(_scens(), n_lanes=2, bank=PriorBank().freeze()).run()
    _assert_bitwise(base, fb)


def test_stream_online_transfer_within_one_run():
    """Later admissions of an already-seen key are seeded from earlier
    retirements."""
    reqs = [Scenario(default_vgg19_problem(), seed=s, budget=8)
            for s in range(4)]
    base = _stream(reqs, n_lanes=2).run()
    bank = PriorBank()
    warm = _stream(reqs, n_lanes=2, bank=bank).run()
    assert bank.stats()["hits"] >= 1
    assert any(not np.array_equal(np.asarray(a.utilities),
                                  np.asarray(b.utilities))
               for a, b in zip(base, warm))
    for a, b in zip(base, warm):
        assert b.best_utility >= a.best_utility - 1e-9


def test_stream_resume_carries_bank(tmp_path):
    em1, em2 = [], []
    eng = _stream(_scens(seeds=(0, 1, 2)), n_lanes=2, bank=PriorBank(),
                  ckpt_dir=str(tmp_path), ckpt_every=1,
                  on_result=em1.append)
    eng.run()
    assert eng.bank.stats()["records"] >= 1
    resumed = StreamingBayesSplitEdge.resume(
        str(tmp_path), _scens(seeds=(0, 1, 2)), config=COLD,
        on_result=em2.append, **CPU)
    assert resumed.bank is not None
    assert resumed.bank.stats()["records"] >= 1
    resumed.run()
    merged = dedup_results(em1 + em2)
    assert sorted(r.index for r in merged) == list(range(6))


def test_streaming_rff_end_to_end():
    cfg = EngineConfig(surrogate=smod.RandomFeatureSurrogate(),
                       warm_start=False)
    res = _stream(_scens(), cfg, n_lanes=2).run()
    assert len(res) == len(_scens())
    assert all(np.isfinite(r.best_utility) for r in res)


def test_engine_config_and_unknown_kwarg():
    cfg = EngineConfig(n_init=7, warm_start=False)
    eng = _stream(_scens(seeds=(0,)), cfg, n_lanes=2)
    assert eng.n_init == 7 and eng.config == cfg
    with pytest.raises(TypeError):
        _stream(_scens(), not_a_knob=1)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingBayesSplitEdge(_scens(), n_lanes=2)


def test_manifest_carries_stream_metadata(tmp_path):
    """A forced snapshot's manifest names the static shapes (what
    ``resume`` validates before loading arrays) and the reference's
    keys and dtypes."""
    reqs = [scenario_from_request("vgg19", 0.0, 6, i) for i in range(3)]
    eng = _stream(reqs, n_lanes=4, ckpt_dir=str(tmp_path))
    list(eng.serve())
    step = eng.checkpoint_now()
    assert latest_step(str(tmp_path)) == step
    man = load_manifest(str(tmp_path), step)
    meta = man["metadata"]["stream"]
    assert (meta["n_lanes"], meta["n_shards"], meta["l_pad"],
            meta["budget_max"]) == (4, 1, 37, 6)
    keys = man["keys"]
    assert keys["pools/0/order"]["dtype"] == "int64"
    assert keys["pools/0/it"]["dtype"] == "int64"
    assert keys["pools/0/state/x"] == dict(shape=[4, 64, 2],
                                           dtype="float32")
    assert keys["pools/0/state/n"]["dtype"] == "int32"
    assert keys["pools/0/state/active"]["dtype"] == "bool"
    assert keys["pools/0/state/theta/log_ls"]["dtype"] == "float32"
    with pytest.raises(ValueError, match="n_lanes"):
        StreamingBayesSplitEdge.resume(str(tmp_path), reqs, n_lanes=8,
                                       **CPU)


# ---------------------------------------------------------------------------
# admission seeds: independent of the admission's size
# ---------------------------------------------------------------------------


def _seeded(staged, k, cfg):
    stacked = wr.stack_staged(staged[:k], 37, wr._next_pow2(k))
    state, _ = wr.admit_init(stacked, torch.as_tensor(
        np.zeros((1, 2)), dtype=torch.float32), cfg, True)
    return ({n: v[0].numpy().tobytes() for n, v in state["theta"].items()},
            int(state["fit_steps"][0]), bool(state["seeded"][0]))


@pytest.mark.parametrize("bank_hit", [False, True])
def test_admission_seed_is_independent_of_admission_size(bank_hit,
                                                         monkeypatch):
    """A lane's seeded theta and seed-fit steps are the same bits when it
    is admitted alone or with 1, 3 or 7 others — cold seeds, and warm
    seeds from a bank hit. Every seed fit sees exactly LANE_WIDTH lanes
    (on the card the batched library calls give a lane other bits at
    other lane counts; the CPU's do not, so the count is checked too)."""
    widths = []
    for name in ("fit", "fit_from"):
        fn = getattr(smod.GPSurrogate, name)

        def spy(self, data, *a, _fn=fn, **k):
            widths.append(data["x"].shape[0])
            return _fn(self, data, *a, **k)
        monkeypatch.setattr(smod.GPSurrogate, name, spy)
    reqs = [scenario_from_request("vgg19", (-1) ** i * 1.5, 12, i)
            for i in range(8)]
    bank = None
    if bank_hit:
        bank = PriorBank()
        for i, sc in enumerate(reqs):
            bank.record_result(sc, (-0.5 + 0.1 * i, 0.2, -3.0),
                               [50.0, 60.0], [True, True],
                               np.array([0.4, 0.6]), 60.0, True)
        bank.freeze()
    staged = [wr.stage_scenario(sc, 37, 9, True, np.zeros((1, 2)),
                                bank=bank, device="cpu") for sc in reqs]
    assert all(bool(st["bank_hit"]) == bank_hit for st in staged)
    cfg = wr.WholeRunConfig(
        n_init=9, n_max_repeat=5, budget_max=12, l_pad=37,
        constraint_aware=True, gp_feasible_only=True, use_schedules=True,
        warm_start=True, gp=EngineConfig().gp_cfg, use_prior=bank_hit)
    alone = _seeded(staged, 1, cfg)
    assert alone[2]
    for k in (2, 4, 8):
        assert _seeded(staged, k, cfg) == alone, k
    assert widths and set(widths) == {wr.LANE_WIDTH}
    assert len(widths) == 4 * (2 if bank_hit else 1)


# ---------------------------------------------------------------------------
# the CNN + LM blend, within the port and against the reference
# ---------------------------------------------------------------------------


def _lm_batch(make=make_hetero_scenarios, archs=MIXED_TRACE_ARCHS):
    return make(seeds=(0,), budgets=(12,), archs=archs)


@pytest.fixture(scope="module")
def lm_stream():
    return _stream(_lm_batch(), n_lanes=8).run()


def test_mixed_lm_streaming_matches_wholerun(lm_stream):
    r_o = WholeRunBayesSplitEdge(_lm_batch(), COLD_U, **CPU).run()
    _assert_bitwise(lm_stream, r_o)


def test_mixed_lm_streaming_gives_the_reference_s_answers(lm_stream):
    assert MIXED_TRACE_ARCHS == REF_MIXED
    ref = RefStream(_lm_batch(ref_hetero, REF_MIXED), n_lanes=8,
                    warm_start=False).run()
    assert len(ref) == len(lm_stream) == 6
    for r, g in zip(ref, lm_stream):
        assert g.best_accuracy == r.best_accuracy
        assert (g.best_a is None) == (r.best_a is None)
        assert g.n_evals == r.n_evals
        np.testing.assert_allclose(g.incumbent_trace, r.incumbent_trace,
                                   atol=QUANTUM)
    # the offline reference agrees with its own stream (its contract)
    ref_o = RefWholeRun(_lm_batch(ref_hetero, REF_MIXED), warm_start=False,
                        compact=False).run()
    assert [r.utilities for r in ref] == [r.utilities for r in ref_o]


def test_stream_stats_are_json():
    eng = _stream(_vgg(seeds=(0,), budgets=(10,)), n_lanes=1,
                  budget_max=10)
    eng.run()
    json.dumps(eng.stream_stats())
