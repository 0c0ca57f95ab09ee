"""Algorithm 1 in the port, end to end on the CPU: the sequential
``BayesSplitEdge`` against the reference, and the cases of
``tests/test_core_bo.py`` mirrored onto ``repro_torch``. Tolerances are
those of the mirrored tests; against the reference the final quantized
accuracy and feasibility are equal and the incumbent trace is within
one 1/64 accuracy quantum (docs/engine.md §warm-start)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import BayesSplitEdge as RefBSE
from repro.core import default_vgg19_problem as ref_vgg
from repro_torch.core import gp as gpm
from repro_torch.core import torch_cost
from repro_torch.core.acquisition import (AcqWeights, assemble_candidates,
                                          candidate_grid,
                                          expected_improvement,
                                          hybrid_scores, maximize, schedule)
from repro_torch.core.bo import (BASIC_BO_KW, BasicBO, BayesSplitEdge,
                                 _init_grid)
from repro_torch.core.problem import (default_resnet101_problem,
                                      default_vgg19_problem)

torch.set_num_threads(1)
CPU = dict(device="cpu")
QUANTUM = 100.0 / 64.0


def _fit_gp(xs, ys, cfg=gpm.GPConfig()):
    m = cfg.max_points
    mask = np.arange(m) < len(xs)
    x = np.zeros((m, 2))
    x[:len(xs)] = xs
    y = np.zeros(m)
    y[:len(ys)] = ys
    return gpm.fit(gpm.as_dataset(dict(x=x, y=y, mask=mask), "cpu"), cfg)


def _t(v):
    return torch.as_tensor(np.asarray(v, np.float32))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_sequential_run_matches_reference():
    pb_r, pb_p = ref_vgg(), default_vgg19_problem()
    ref = RefBSE(pb_r, budget=20).run(seed=0)
    got = BayesSplitEdge(pb_p, budget=20, **CPU).run(seed=0)
    assert got.best_accuracy == ref.best_accuracy == pytest.approx(87.5)
    assert pb_p.denormalize(got.best_a)[0] == 7
    assert got.n_evals == ref.n_evals
    assert got.feasible == ref.feasible
    np.testing.assert_allclose(got.incumbent_trace, ref.incumbent_trace,
                               atol=QUANTUM)


def test_init_grid_draws_like_the_reference():
    from repro.core.bo import _init_grid as ref_init
    for seed in (0, 3):
        np.testing.assert_array_equal(
            _init_grid(9, np.random.default_rng(seed)),
            ref_init(9, np.random.default_rng(seed)))


def test_basic_bo_flags_equal_reference():
    from repro.core.bo import BASIC_BO_KW as REF_KW
    assert BASIC_BO_KW == REF_KW


# ---------------------------------------------------------------------------
# tests/test_core_bo.py, mirrored
# ---------------------------------------------------------------------------


def test_gp_interpolates_training_points():
    rng = np.random.default_rng(0)
    xs = rng.random((12, 2))
    ys = np.sin(3 * xs[:, 0]) + xs[:, 1] ** 2
    gp = _fit_gp(xs, ys)
    for x, y in zip(xs, ys):
        mu, sig = gpm.posterior(gp, _t(x))
        assert abs(float(mu) - y) < 0.15, (float(mu), y)


def test_gp_posterior_matches_exact_formula():
    """Masked/padded Cholesky path == textbook dense GP on active points."""
    rng = np.random.default_rng(1)
    xs = rng.random((8, 2))
    ys = rng.random(8)
    cfg = gpm.GPConfig(fit_steps=1)
    gp = _fit_gp(xs, ys, cfg)
    theta = gp["theta"]
    ls, sv, nv = (float(torch.exp(theta["log_ls"])),
                  float(torch.exp(theta["log_sv"])),
                  float(torch.exp(theta["log_nv"])))
    y_std = (ys - float(gp["y_mu"])) / float(gp["y_sigma"])
    K = gpm.matern52(_t(xs), _t(xs), ls, sv).double().numpy()
    K += (nv + cfg.jitter) * np.eye(8)
    xstar = np.array([0.3, 0.7])
    ks = gpm.matern52(_t(xstar[None]), _t(xs), ls, sv).double().numpy()[0]
    mu_ref = ks @ np.linalg.solve(K, y_std)
    mu_ref = mu_ref * float(gp["y_sigma"]) + float(gp["y_mu"])
    var_ref = sv - ks @ np.linalg.solve(K, ks)
    mu, sig = gpm.posterior(gp, _t(xstar))
    np.testing.assert_allclose(float(mu), mu_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(sig), np.sqrt(max(var_ref, 1e-12)) * float(gp["y_sigma"]),
        rtol=1e-3, atol=1e-5)


def test_gp_uncertainty_grows_away_from_data():
    gp = _fit_gp(np.array([[0.5, 0.5]]), np.array([1.0]),
                 gpm.GPConfig(fit_steps=1))
    _, s_near = gpm.posterior(gp, _t([0.5, 0.5]))
    _, s_far = gpm.posterior(gp, _t([0.0, 0.0]))
    assert float(s_far) > float(s_near)


@settings(max_examples=40, deadline=None)
@given(st.floats(-3, 3), st.floats(0.01, 2.0), st.floats(-3, 3))
def test_ei_nonnegative_and_monotone_in_mu(mu, sigma, best):
    e1 = float(expected_improvement(_t(mu), _t(sigma), _t(best)))
    e2 = float(expected_improvement(_t(mu + 0.5), _t(sigma), _t(best)))
    assert e1 >= -1e-6
    assert e2 >= e1 - 1e-5


def test_ei_zero_sigma_is_finite():
    for mu in (-1.0, 0.0, 2.5):
        for sigma in (0.0, 1e-30, 1e-9):
            e = float(expected_improvement(_t(mu), _t(sigma), _t(0.5)))
            assert np.isfinite(e)
            assert e >= -1e-6
    assert float(expected_improvement(_t(2.0), _t(0.0), _t(0.5))
                 ) == pytest.approx(1.5, abs=1e-5)
    assert float(expected_improvement(_t(-2.0), _t(0.0), _t(0.5))
                 ) == pytest.approx(0.0, abs=1e-5)


def test_zero_variance_posterior_scores_finite():
    gp = _fit_gp(np.array([[0.4, 0.4], [0.6, 0.6]]), np.array([1.0, 1.0]),
                 gpm.GPConfig(fit_steps=1))
    cand = _t(np.random.default_rng(0).random((16, 2)))
    s = hybrid_scores(gp, cand, 1.0, torch.zeros(16), 1.0, 0.1, 2.0, 2.0,
                      float(gp["y_sigma"]))
    assert torch.all(torch.isfinite(s))


def test_maximize_grid_consistent_argmax():
    """With refinement disabled, maximize returns exactly the
    candidate-block argmax of the hybrid scores."""
    pb = default_vgg19_problem()
    rng = np.random.default_rng(5)
    xs = rng.random((10, 2))
    ys = 80.0 + 5.0 * rng.random(10)
    gp = _fit_gp(xs, ys)
    w = AcqWeights()
    grid = candidate_grid(32)
    a = maximize(gp, pb, w, t_norm=0.0, best_feasible=84.0, grid=grid,
                 refine_steps=0)
    cand = assemble_candidates(pb, grid, None, True)
    pen = torch_cost.penalty(pb.device_params(device="cpu"), _t(cand))
    scores = hybrid_scores(gp, _t(cand), _t(84.0), pen, w.lam_base0,
                           w.lam_g0, w.lam_p, w.beta, float(gp["y_sigma"]))
    np.testing.assert_allclose(a, cand[int(torch.argmax(scores))], atol=1e-6)


def test_schedule_decays_exponentially():
    assert schedule(1.0, 0.1, 0.0) == pytest.approx(1.0)
    assert schedule(1.0, 0.1, 1.0) == pytest.approx(0.1)
    assert schedule(1.0, 0.1, 0.5) == pytest.approx(10 ** -0.5)
    assert schedule(0.0, 0.1, 0.5) == 0.0


def test_vgg19_problem_reproduces_table1_optimum():
    pb = default_vgg19_problem()
    a, _ = pb.exhaustive_optimum(n_power=501)
    l, p = pb.denormalize(a)
    e, t = pb.constraint_values(a)
    _, acc = pb._accuracy(l, p)
    assert l == 7
    assert abs(p - 0.38) < 0.005
    assert abs(e - 1.53) < 0.02
    assert abs(t - 5.00) < 0.01
    assert acc == pytest.approx(87.5)


def test_accuracy_quantization_levels():
    pb = default_vgg19_problem()
    accs = set()
    for l in range(1, pb.L + 1):
        a = pb.project_feasible(pb.normalize(l, 0.45))
        _, acc = pb._accuracy(*pb.denormalize(a))
        accs.add(round(acc, 2))
    assert accs <= {0.0, 84.38, 85.94, 87.5}, accs


def test_penalty_zero_iff_feasible():
    pb = default_vgg19_problem()
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.random(2)
        assert (pb.penalty(a) == 0.0) == pb.feasible(a)


def test_penalty_batch_matches_scalar():
    pb = default_vgg19_problem()
    A = np.random.default_rng(1).random((20, 2))
    for a, pv in zip(A, pb.penalty_batch(A)):
        single = pb.penalty(a)
        if np.isinf(single):
            assert pv >= 1e5
        else:
            np.testing.assert_allclose(pv, single, rtol=1e-9)


def test_bayes_split_edge_finds_optimum_within_budget():
    pb = default_vgg19_problem()
    res = BayesSplitEdge(pb, budget=20, **CPU).run(seed=0)
    l, p = pb.denormalize(res.best_a)
    assert l == 7
    assert res.best_accuracy == pytest.approx(87.5)
    assert res.n_evals <= 20


def test_bo_respects_budget_and_history():
    pb = default_vgg19_problem()
    res = BasicBO(pb, budget=15, **CPU).run(seed=1)
    assert res.n_evals <= 15
    assert len(pb.history) == res.n_evals


def test_no_feasible_solution_is_explicit():
    """Impossible energy budget: best_a=None with -inf utility and no
    feasible evals."""
    from repro_torch.core.cost_model import Budgets, CostModel
    from repro_torch.core.problem import SplitInferenceProblem
    from repro_torch.core.profiles import vgg19_profile

    gain = default_vgg19_problem().gain_db
    pb = SplitInferenceProblem(
        CostModel(vgg19_profile(), budgets=Budgets(e_max_j=1e-9)), gain)
    res = BayesSplitEdge(pb, budget=12, **CPU).run(seed=0)
    assert res.best_a is None
    assert res.best_utility == -np.inf
    assert res.best_accuracy == 0.0
    assert not any(res.feasible)
    assert all(v == 0.0 for v in res.incumbent_trace)


def test_resnet_pair_converges():
    pb = default_resnet101_problem()
    res = BayesSplitEdge(pb, budget=20, **CPU).run(seed=0)
    a, u_star = pb.exhaustive_optimum(n_power=201)
    assert res.best_utility >= u_star - 0.2
