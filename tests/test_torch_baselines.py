"""The port's baselines (``repro_torch.baselines``) against the
reference's (``repro.baselines``) on seeds 0-2, the same problem built
by each package.

* The host searches — exhaustive (at 101 powers here; the full 1,001 in
  ``tests/test_torch_table1_answers.py``), random, DIRECT, CMA-ES and
  the two greedy heuristics — are numpy over the problem and give the
  reference's ``BOResult`` exactly: every evaluation's utility,
  accuracy and feasibility bit, the incumbent trace and the best point.
* PPO runs on the reference's ``jax.random`` draws (both nets' initial
  weights and the action noise, by the reference's key splits): every
  evaluation's split layer and feasibility bit and the best accuracy
  are equal, every power within ``table1_torch.PPO_POWER_TOL`` (the
  float32 policy's last bits differ across frameworks).
"""
import numpy as np
import pytest
import torch

from benchmarks.table1_torch import PPO_POWER_TOL
from repro import baselines as ref
from repro.core import default_vgg19_problem as ref_problem
from repro_torch import baselines as port
from repro_torch.core import default_vgg19_problem as port_problem
from tests.test_torch_table1_answers import reference_ppo_draws

torch.set_num_threads(1)
SEEDS = (0, 1, 2)
HOST = {
    "exhaustive": lambda m, pb: m.ExhaustiveSearch(pb, n_power=101),
    "random": lambda m, pb: m.RandomSearch(pb),
    "direct": lambda m, pb: m.DirectSearch(pb),
    "cmaes": lambda m, pb: m.CMAES(pb),
    "transmit_first": lambda m, pb: m.TransmitFirst(pb),
    "compute_first": lambda m, pb: m.ComputeFirst(pb),
}
HOST_CASES = [(name, seed) for name in HOST for seed in SEEDS]


def _same_result(got, want):
    assert got.n_evals == want.n_evals
    for k in ("utilities", "accuracies", "feasible", "incumbent_trace"):
        assert list(getattr(got, k)) == list(getattr(want, k)), k
    assert got.best_utility == want.best_utility
    assert got.best_accuracy == want.best_accuracy
    assert (got.best_a is None) == (want.best_a is None)
    if want.best_a is not None:
        assert np.array_equal(got.best_a, want.best_a)


@pytest.mark.parametrize("name,seed", HOST_CASES,
                         ids=[f"{n}-{s}" for n, s in HOST_CASES])
def test_host_baseline_gives_the_reference_s_result(name, seed):
    pb_ref, pb_port = ref_problem(), port_problem()
    want = HOST[name](ref, pb_ref).run(seed=seed)
    got = HOST[name](port, pb_port).run(seed=seed)
    _same_result(got, want)
    assert [(h.l, h.p_w, h.feasible) for h in pb_port.history] == [
        (h.l, h.p_w, h.feasible) for h in pb_ref.history]


def test_exhaustive_optimal_band_is_the_reference_s():
    want = ref.ExhaustiveSearch(ref_problem(), n_power=101).optimal_band()
    got = port.ExhaustiveSearch(port_problem(), n_power=101).optimal_band()
    assert got == want and got


@pytest.mark.parametrize("seed", SEEDS)
def test_ppo_on_the_reference_s_draws(seed):
    pb_ref, pb_port = ref_problem(), port_problem()
    want = ref.PPOBaseline(pb_ref).run(seed=seed)
    got = port.PPOBaseline(pb_port, device="cpu").run(
        seed=seed, draws=reference_ppo_draws(seed))
    assert got.n_evals == want.n_evals == 100
    assert [h.l for h in pb_port.history] == [h.l for h in pb_ref.history]
    assert list(got.feasible) == list(want.feasible)
    assert list(got.accuracies) == list(want.accuracies)
    assert got.best_accuracy == want.best_accuracy
    p_got = np.array([h.p_w for h in pb_port.history])
    p_want = np.array([h.p_w for h in pb_ref.history])
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=PPO_POWER_TOL)
    assert pb_port.denormalize(got.best_a)[0] == pb_ref.denormalize(
        want.best_a)[0]
    assert got.best_a.dtype == np.float32      # the action stays float32


def test_ppo_own_draws_repeat_and_differ_by_seed():
    def run(seed):
        pb = port_problem()
        res = port.PPOBaseline(pb, device="cpu").run(seed=seed)
        return res, [(h.l, h.p_w) for h in pb.history]

    (a, ha), (b, hb), (c, hc) = run(0), run(0), run(1)
    assert ha == hb and a.utilities == b.utilities
    assert ha != hc
    d = port.PPOBaseline(port_problem(), device="cpu").draw(0)
    assert [tuple(w.shape) for w in d["pi"]] == [(2, 32), (32,), (32, 2),
                                                 (2,)]
    assert [tuple(w.shape) for w in d["vf"]] == [(2, 32), (32,), (32, 1),
                                                 (1,)]
    assert tuple(d["noise"].shape) == (100, 2)


def test_ppo_rejects_noise_of_another_budget():
    draws = reference_ppo_draws(0, budget=10)
    with pytest.raises(ValueError, match="action noise"):
        port.PPOBaseline(port_problem(), device="cpu").run(0, draws=draws)
