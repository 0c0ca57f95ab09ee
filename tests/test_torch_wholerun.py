"""The port's whole-run engine on the CPU against the reference's.

Across frameworks (parity level 3): the cold whole run gives each
scenario the reference's quantized accuracy, feasibility and eval count,
with incumbent traces within one 1/64 accuracy quantum. Within the port,
bitwise (level 4): compacted == uncompacted on cold fits, packed ==
unpacked, ``run_packed_shards`` == unpacked, a mixed-architecture batch
== its architectures run alone. Warm refits stay within the
reference's warm-vs-cold trace bound. Staging and the lane operations
the streaming server will drive (admit, retire, resize, quarantine) give
the reference's state on a 4-lane batch.

The reference's answers on the mixes ``chip_smoke.py`` runs on the card
are held by ``tests/test_torch_wholerun_answers.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import WholeRunBayesSplitEdge as RefWholeRun
from repro.core import make_vgg19_scenarios as ref_vgg_scenarios
from repro.core import wholerun as rwr
from repro_torch.core import (BatchedBayesSplitEdge, Scenario,
                              WholeRunBayesSplitEdge, default_vgg19_problem,
                              make_hetero_scenarios, make_vgg19_scenarios,
                              run_packed_shards)
from repro_torch.core import wholerun as wr

torch.set_num_threads(1)
CPU = dict(device="cpu")
QUANTUM = 100.0 / 64.0
WARM_TRACE_TOL = 0.5                 # tests/test_wholerun.py's bound


def _sweep(make):
    return make(seeds=(0, 1), gain_offsets_db=(0.0, -2.0), budgets=(14,))


def _assert_bitwise(res_a, res_b):
    assert len(res_a) == len(res_b)
    for a, b in zip(res_a, res_b):
        assert a.n_evals == b.n_evals
        assert a.utilities == b.utilities
        assert a.accuracies == b.accuracies
        assert a.feasible == b.feasible
        assert a.incumbent_trace == b.incumbent_trace
        assert a.best_utility == b.best_utility
        assert np.array_equal(a.best_a, b.best_a)


def _assert_raw_bitwise(raw_a, raw_b, rows):
    for k, v in raw_a.items():
        if isinstance(v, dict):
            _assert_raw_bitwise(v, raw_b[k], rows)
        else:
            assert v[:rows].tobytes() == raw_b[k][:rows].tobytes(), k


def _trace_div(r1, r2):
    m = min(r1.n_evals, r2.n_evals)
    return float(np.max(np.abs(np.asarray(r1.incumbent_trace[:m])
                               - np.asarray(r2.incumbent_trace[:m]))))


# ---------------------------------------------------------------------------
# across frameworks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_cold():
    return RefWholeRun(_sweep(ref_vgg_scenarios), warm_start=False).run()


@pytest.fixture(scope="module")
def port_cold():
    return WholeRunBayesSplitEdge(_sweep(make_vgg19_scenarios),
                                  warm_start=False, **CPU).run()


def test_cold_whole_run_matches_reference(ref_cold, port_cold):
    assert len(port_cold) == len(ref_cold) == 4
    for r, g in zip(ref_cold, port_cold):
        assert g.best_accuracy == r.best_accuracy
        assert (g.best_a is None) == (r.best_a is None)
        assert g.n_evals == r.n_evals
        assert len(g.incumbent_trace) == len(r.incumbent_trace)
        np.testing.assert_allclose(g.incumbent_trace, r.incumbent_trace,
                                   atol=QUANTUM)


def test_warm_within_tolerance_of_cold(port_cold):
    eng = WholeRunBayesSplitEdge(_sweep(make_vgg19_scenarios), **CPU)
    warm = eng.run()
    for c, w in zip(port_cold, warm):
        assert w.n_evals == c.n_evals
        assert w.best_accuracy == c.best_accuracy
        assert _trace_div(c, w) < WARM_TRACE_TOL
    stats = eng.fit_cost_stats()
    assert stats["warm_steps_mean"] < eng.gp_cfg.fit_steps / 3
    lanes = eng.lane_stats()
    assert 0 < lanes["acq_iters"] <= sum(e["iters"]
                                         for e in lanes["lane_log"])


# ---------------------------------------------------------------------------
# within the port, bitwise
# ---------------------------------------------------------------------------


def _small_hetero():
    return make_hetero_scenarios(seeds=(0,), budgets=(6, 10, 14))


@pytest.fixture(scope="module")
def uncompacted():
    eng = WholeRunBayesSplitEdge(_small_hetero(), warm_start=False,
                                 compact=False, **CPU)
    return eng.run(), eng._last_raw


def test_cold_compacted_is_bitwise(uncompacted):
    res_u, raw_u = uncompacted
    eng = WholeRunBayesSplitEdge(_small_hetero(), warm_start=False, **CPU)
    res_c = eng.run()
    _assert_bitwise(res_c, res_u)
    _assert_raw_bitwise(eng._last_raw, raw_u, len(res_c))
    log = eng.lane_stats()["lane_log"]
    assert len(log) > 1 and log[-1]["lanes"] < log[0]["lanes"]


@pytest.mark.parametrize("how", ["pack", "shards"])
def test_packing_is_bitwise(uncompacted, how):
    res_u, raw_u = uncompacted
    if how == "pack":
        eng = WholeRunBayesSplitEdge(_small_hetero(), warm_start=False,
                                     pack=True, **CPU)
        res = eng.run()
        _assert_raw_bitwise(eng._last_raw, raw_u, len(res))
    else:
        res = run_packed_shards(_small_hetero(), n_shards=2,
                                warm_start=False, **CPU)
    _assert_bitwise(res, res_u)


def test_mixed_batch_equals_per_arch_runs(uncompacted):
    """The VGG19 + ResNet101 batch (padded to L_max 37) equals each
    architecture run as its own batch (at its own L), bit for bit."""
    res_u, _ = uncompacted
    scs = _small_hetero()
    for arch in (37, 36):
        idx = [i for i, sc in enumerate(scs) if sc.problem.L == arch]
        own = WholeRunBayesSplitEdge([scs[i] for i in idx],
                                     warm_start=False, **CPU)
        assert own.l_pad == arch
        _assert_bitwise(own.run(), [res_u[i] for i in idx])


def test_single_lane_batch_and_all_lanes_dead_at_init():
    one = [Scenario(default_vgg19_problem(), seed=0, budget=11)]
    r_nc = WholeRunBayesSplitEdge(one, warm_start=False, compact=False,
                                  **CPU).run()
    r_c = WholeRunBayesSplitEdge(one, warm_start=False, **CPU).run()
    _assert_bitwise(r_c, r_nc)
    dead = [Scenario(default_vgg19_problem(), seed=s, budget=5)
            for s in (0, 1, 2)]
    eng = WholeRunBayesSplitEdge(dead, **CPU)
    res = eng.run()
    ref = BatchedBayesSplitEdge(dead, **CPU).run()
    assert eng.lane_stats()["n_dispatches"] == 0
    for a, b in zip(res, ref):
        assert a.n_evals == len(a.utilities) == b.n_evals == 9
        assert a.best_accuracy == b.best_accuracy


def test_lane_chunks_are_full_width():
    """The fit + acquisition see chunks of exactly LANE_WIDTH lanes, the
    short one padded with copies of its first lane; every lane comes
    back once, in order."""
    seen = []

    def fn(c):
        seen.append(c["budget"].shape[0])
        return dict(v=c["budget"] * 10, theta=dict(t=c["budget"] + 0.5))

    for s in (1, 5, 16, 21, 40):
        seen.clear()
        lanes = dict(budget=torch.arange(s) + 100)
        out = wr._by_width(fn, lanes, s)
        assert seen == [wr.LANE_WIDTH] * (-(-s // wr.LANE_WIDTH))
        assert torch.equal(out["v"], lanes["budget"] * 10)
        assert torch.equal(out["theta"]["t"], lanes["budget"] + 0.5)


def test_phase_progress_with_stale_dead_lane_dataset():
    """A retired lane whose dataset outgrew the live lanes' bucket must
    not stop a phase at zero iterations."""
    scs = [Scenario(default_vgg19_problem(), seed=s, budget=12)
           for s in range(4)]
    eng = WholeRunBayesSplitEdge(scs, **CPU)
    cfg = wr.WholeRunConfig(
        n_init=eng.n_init, n_max_repeat=eng.n_max_repeat, budget_max=30,
        l_pad=eng.l_pad, constraint_aware=True, gp_feasible_only=True,
        use_schedules=True, warm_start=True, gp=eng.gp_cfg)
    stacked = eng._stacked()
    grid = torch.as_tensor(eng.grid).to(torch.float32)
    state, pen = wr.init_run(stacked, grid, cfg)
    run_data = dict(params=stacked["params"], boundary=stacked["boundary"],
                    budget=stacked["budget"], pen=pen)
    state = dict(state, active=torch.tensor([False, True, True, True]))
    state["n_pts"] = state["n_pts"].clone()
    state["n_pts"][0] = 20
    _, it = wr.run_phase(run_data, state, 1, grid,
                         wr.acq_wvec(eng.weights, "cpu"), cfg, 16, False)
    assert it > 1


# ---------------------------------------------------------------------------
# staging and the lane operations against the reference
# ---------------------------------------------------------------------------


def _compare(port, ref, path=""):
    """A port tree (tensors) against a reference tree (JAX arrays):
    integer and bool leaves equal, float leaves within 1e-6."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _compare(port[k], ref[k], f"{path}/{k}")
        return
    r = np.asarray(ref)
    p = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    assert p.shape == r.shape, path
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        np.testing.assert_array_equal(p, r, err_msg=path)


def _pair(budgets=(10, 12, 11, 6), seeds=(0, 1, 2, 3)):
    from repro.core import Scenario as RefScenario
    from repro.core import default_resnet101_problem as ref_resnet
    from repro.core import default_vgg19_problem as ref_vgg
    from repro_torch.core import default_resnet101_problem
    archs = [(ref_vgg, default_vgg19_problem),
             (ref_resnet, default_resnet101_problem)]
    ref = [RefScenario(archs[i % 2][0](), seed=s, budget=b)
           for i, (s, b) in enumerate(zip(seeds, budgets))]
    port = [Scenario(archs[i % 2][1](), seed=s, budget=b)
            for i, (s, b) in enumerate(zip(seeds, budgets))]
    return ref, port


def _configs(warm_start=False):
    from repro.core.gp import GPConfig as RefGPConfig
    from repro_torch.core.gp import GPConfig
    kw = dict(n_init=9, n_max_repeat=5, budget_max=12, l_pad=37,
              constraint_aware=True, gp_feasible_only=True,
              use_schedules=True, warm_start=warm_start)
    return (rwr.WholeRunConfig(gp=RefGPConfig(), **kw),
            wr.WholeRunConfig(gp=GPConfig(), **kw))


def _staged_pair(ref_scs, port_scs):
    from repro.core.acquisition import candidate_grid
    fill = candidate_grid(64)[:1]
    r = [rwr.stage_scenario(sc, 37, 9, True, fill) for sc in ref_scs]
    p = [wr.stage_scenario(sc, 37, 9, True, fill, **CPU) for sc in port_scs]
    return r, p


def test_staging_equals_reference():
    ref_scs, port_scs = _pair()
    r, p = _staged_pair(ref_scs, port_scs)
    for a, b in zip(r, p):
        for k in ("init_pts", "boundary"):
            np.testing.assert_array_equal(b[k], a[k])
        assert b["budget"] == a["budget"]
        assert b["bank_hit"] is a["bank_hit"] is False
    _compare(wr.stack_staged(p, 37, 8), rwr.stack_staged(r, 37, 8))


def _init_pair(cfgs, ref_scs, port_scs):
    from repro.core.acquisition import candidate_grid
    r, p = _staged_pair(ref_scs, port_scs)
    rs, ps = rwr.stack_staged(r, 37, 4), wr.stack_staged(p, 37, 4)
    grid = candidate_grid(64)
    ref = rwr.init_run(rs, jnp.asarray(grid, jnp.float32), cfgs[0])
    port = wr.init_run(ps, torch.as_tensor(grid).to(torch.float32), cfgs[1])
    ref_rd = dict(params=rs["params"], boundary=rs["boundary"],
                  budget=rs["budget"], pen=ref[1])
    port_rd = dict(params=ps["params"], boundary=ps["boundary"],
                   budget=ps["budget"], pen=port[1])
    return (ref[0], ref_rd), (port[0], port_rd)


def test_init_run_equals_reference():
    cfgs = _configs()
    (r_st, r_rd), (p_st, p_rd) = _init_pair(cfgs, *_pair())
    _compare(p_st, r_st)
    _compare(p_rd, r_rd)


@pytest.mark.parametrize("op", ["admit", "retire", "resize_grow",
                                "resize_shrink", "quarantine",
                                "quarantine_scrub", "gather"])
def test_lane_operation_equals_reference(op):
    cfgs = _configs()
    (r_st, r_rd), (p_st, p_rd) = _init_pair(cfgs, *_pair())
    if op == "admit":
        (n_r, nrd_r), (n_p, nrd_p) = _init_pair(
            cfgs, *_pair(budgets=(10, 12, 9, 7), seeds=(5, 6, 7, 8)))
        lanes = np.array([2, 0])
        got = wr.admit_lanes(p_st, p_rd, n_p, nrd_p, lanes)
        want = rwr.admit_lanes(r_st, r_rd, n_r, nrd_r, jnp.asarray(lanes))
    elif op == "retire":
        # lane 3 (budget 6) never found a feasible point
        lanes = np.array([1, 3])
        r_st = dict(r_st, has_best=r_st["has_best"].at[3].set(False))
        p_st = dict(p_st, has_best=p_st["has_best"].clone())
        p_st["has_best"][3] = False
        got = (wr.retire_lanes(p_st, p_rd, lanes), p_rd)
        want = (rwr.retire_lanes(r_st, r_rd, jnp.asarray(lanes)), r_rd)
    elif op.startswith("resize"):
        occ, s_next = ((np.array([3, 1]), 8) if op == "resize_grow"
                       else (np.array([2]), 2))
        got = wr.resize_lanes(p_st, p_rd, occ, s_next)
        want = rwr.resize_lanes(r_st, r_rd, occ, s_next)
    elif op == "gather":
        live = np.array([1, 2, 3])
        got = wr.gather_live_lanes(p_st, p_rd, live, 4)[:2]
        want = rwr.gather_live_lanes(r_st, r_rd, live, 4)[:2]
    else:
        scrub = op == "quarantine_scrub"
        # lane 2's dataset holds a poisoned observation
        r_st = dict(r_st, y=r_st["y"].at[2, 1].set(jnp.nan),
                    active=r_st["active"].at[2].set(False),
                    fault=r_st["fault"].at[2].set(True))
        p_st = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in p_st.items()}
        p_st["y"][2, 1] = float("nan")
        p_st["active"][2] = False
        p_st["fault"][2] = True
        lanes = np.array([2])
        got = (wr.quarantine_lanes(p_st, lanes, cfgs[1], scrub), p_rd)
        want = (rwr.quarantine_lanes(r_st, jnp.asarray(lanes), cfgs[0],
                                     scrub), r_rd)
    _compare(got[0], want[0])
    _compare(got[1], want[1])


def test_stream_phase_and_admit_init_equal_reference():
    """``admit_init`` (cold seed of the carry) and one ``stream_phase``
    give the reference's lane ledger, and traces within one quantum
    (parity level 3: the seeded carry itself, 150 float32 Adam steps on
    an init design of near-duplicate points, is not held across
    frameworks)."""
    from repro.core.acquisition import candidate_grid
    from repro.core.acquisition import AcqWeights as RefWeights
    cfgs = _configs(warm_start=True)
    ref_scs, port_scs = _pair()
    r, p = _staged_pair(ref_scs, port_scs)
    rs, ps = rwr.stack_staged(r, 37, 4), wr.stack_staged(p, 37, 4)
    grid = candidate_grid(64)
    rg, pg = jnp.asarray(grid, jnp.float32), torch.as_tensor(grid).to(
        torch.float32)
    r_st, r_pen = rwr.admit_init(rs, rg, cfgs[0], True)
    p_st, p_pen = wr.admit_init(ps, pg, cfgs[1], True)
    assert bool(p_st["seeded"].all())
    np.testing.assert_array_equal(p_st["fit_steps"].numpy(),
                                  np.asarray(r_st["fit_steps"]))
    r_rd = dict(params=rs["params"], boundary=rs["boundary"],
                budget=rs["budget"], pen=r_pen)
    p_rd = dict(params=ps["params"], boundary=ps["boundary"],
                budget=ps["budget"], pen=p_pen)
    w = RefWeights()
    live0 = int(p_st["active"].sum())
    assert live0 == 3                  # lane 3's budget 6 ends at init
    r_out, r_it = rwr.stream_phase(r_rd, r_st, jnp.int32(0), live0, rg,
                                   rwr.acq_wvec(w), cfgs[0], 16, False)
    p_out, p_it = wr.stream_phase(p_rd, p_st, 0, live0, pg,
                                  wr.acq_wvec(w, "cpu"), cfgs[1], 16, False)
    assert p_it == int(r_it) > 0
    for k in ("n", "ev_l", "active", "n_pts", "has_best"):
        np.testing.assert_array_equal(p_out[k].numpy(), np.asarray(r_out[k]),
                                      err_msg=k)
    np.testing.assert_allclose(p_out["ev_trace"].numpy(),
                               np.asarray(r_out["ev_trace"]), atol=QUANTUM)
