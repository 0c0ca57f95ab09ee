"""The port's batched engine on the CPU: scenario for scenario it gives
the reference engine's final quantized accuracy and feasibility, with
incumbent traces within one 1/64 accuracy quantum (the reference's own
warm-vs-cold bound, docs/engine.md §warm-start); and it keeps the
reference's contracts within itself (packing is a pure permutation,
mixed architectures pad to L_max, legacy keywords fold into the
config)."""
import numpy as np
import pytest
import torch

from repro.core import BatchedBayesSplitEdge as RefBatched
from repro.core import make_vgg19_scenarios as ref_vgg_scenarios
from repro_torch.core import (BatchedBayesSplitEdge, BayesSplitEdge,
                              Scenario, default_resnet101_problem,
                              default_vgg19_problem, make_hetero_scenarios,
                              make_mixed_scenarios, make_vgg19_scenarios)
from repro_torch.core.engine_config import EngineConfig, resolve_config
from repro_torch.distributed.sharding import (pack_order, pack_scenarios,
                                              unpack_results)

torch.set_num_threads(1)
CPU = dict(device="cpu")
QUANTUM = 100.0 / 64.0


def _grid4(make):
    return make(seeds=(0, 1), gain_offsets_db=(0.0, -2.0), budgets=(16,))


def test_batched_engine_matches_reference():
    ref = RefBatched(_grid4(ref_vgg_scenarios)).run()
    counts = []
    got = BatchedBayesSplitEdge(_grid4(make_vgg19_scenarios), **CPU).run(
        on_iteration=lambda i, c: counts.append(dict(c)))
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        assert g.best_accuracy == r.best_accuracy
        assert (g.best_a is None) == (r.best_a is None)
        assert g.n_evals == r.n_evals
        assert len(g.incumbent_trace) == len(r.incumbent_trace)
        np.testing.assert_allclose(g.incumbent_trace, r.incumbent_trace,
                                   atol=QUANTUM)
    # on the CPU the block scoring takes the plain version: no launches
    assert counts and all(c["matern_score"] == 0 and not any(c.values())
                          for c in counts)


def test_batched_matches_sequential_in_the_port():
    seeds, budget = [0, 1], 12
    seq = [BayesSplitEdge(default_vgg19_problem(), budget=budget, **CPU)
           .run(seed=s) for s in seeds]
    bat = BatchedBayesSplitEdge(
        [Scenario(default_vgg19_problem(), seed=s, budget=budget)
         for s in seeds], **CPU).run()
    for r1, r2 in zip(seq, bat):
        np.testing.assert_allclose(r1.incumbent_trace, r2.incumbent_trace,
                                   atol=QUANTUM)
        assert r1.best_accuracy == r2.best_accuracy
        assert r1.n_evals == r2.n_evals


def test_mixed_profiles_pad_to_l_max():
    scs = [Scenario(default_vgg19_problem(), seed=0, budget=14),
           Scenario(default_resnet101_problem(), seed=0, budget=14)]
    engine = BatchedBayesSplitEdge(scs, **CPU)
    assert engine.l_pad == 37
    iters = []
    results = engine.run(on_iteration=lambda i, c: iters.append(i))
    assert iters                      # the acquisition ran, not only probes
    assert [r.n_evals for r in results] == [14, 14]
    assert all(r.best_a is not None for r in results)
    with pytest.raises(ValueError):
        BatchedBayesSplitEdge([], **CPU)
    with pytest.raises(ValueError):
        BatchedBayesSplitEdge(scs, config=EngineConfig(l_pad=30), **CPU)


def test_packing_is_a_pure_permutation():
    """pack=True sorts lanes by (L, budget) and unpacks its results: the
    same results as the unpacked batch, bitwise."""
    scs = make_hetero_scenarios(seeds=(0,), budgets=(6, 14))
    plain = BatchedBayesSplitEdge(scs, **CPU).run()
    packed = BatchedBayesSplitEdge(
        make_hetero_scenarios(seeds=(0,), budgets=(6, 14)),
        config=EngineConfig(pack=True), **CPU).run()
    assert max(r.n_evals for r in plain) == 14
    for a, b in zip(plain, packed):
        assert a.utilities == b.utilities
        assert a.incumbent_trace == b.incumbent_trace


def test_pack_helpers_equal_reference():
    from repro.core import make_hetero_scenarios as ref_hetero
    from repro.distributed.sharding import pack_scenarios as ref_pack
    port = make_hetero_scenarios(seeds=(0, 1), budgets=(6, 14, 20),
                                 archs=("vgg19", "resnet101", "qwen2-1.5b"))
    ref = ref_hetero(seeds=(0, 1), budgets=(6, 14, 20),
                     archs=("vgg19", "resnet101", "qwen2-1.5b"))
    np.testing.assert_array_equal(pack_order(port), pack_order(ref))
    for n in (1, 3):
        shards, order = pack_scenarios(port, n)
        r_shards, r_order = ref_pack(ref, n)
        np.testing.assert_array_equal(order, r_order)
        assert [len(s) for s in shards] == [len(s) for s in r_shards]
    assert unpack_results(list("cab"), [2, 0, 1]) == list("abc")


def test_scenario_helpers_shape():
    mixed = make_mixed_scenarios()
    assert [sc.problem.L for sc in mixed] == [37, 36, 37, 36]
    grid = make_vgg19_scenarios(seeds=(0, 1, 2, 3), budgets=(20, 28))
    assert len(grid) == 16
    assert [sc.budget for sc in grid[:4]] == [20, 28, 20, 28]


def test_legacy_keywords_fold_into_the_config():
    kw = dict(n_init=5, grid_n=16, other=1)
    with pytest.warns(DeprecationWarning):
        cfg = resolve_config(None, kw, "BatchedBayesSplitEdge")
    assert (cfg.n_init, cfg.grid_n) == (5, 16) and kw == dict(other=1)
    with pytest.raises(TypeError):
        BatchedBayesSplitEdge([Scenario(default_vgg19_problem())],
                              bogus=1, **CPU)
    base = EngineConfig()
    assert resolve_config(base, {}, "x") is base
    w = EngineConfig(use_grad_term=False, constraint_aware=False
                     ).acq_weights()
    assert (w.lam_g0, w.lam_p) == (0.0, 0.0)
