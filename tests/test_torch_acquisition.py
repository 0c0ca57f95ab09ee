"""The port's acquisition against ``repro.core.acquisition`` given the
same GP cache and constraint surface, carried across by
``repro_torch.interop``: block scores agree within rtol 1e-4 (atol 1e-4:
the scores cancel near zero), the block argmax index is equal, and the
refined point agrees within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as ref_acq
from repro.core import gp as ref_gp
from repro.core import jax_cost
from repro.core.bo import ScenarioState as RefState
from repro.core.problem import default_resnet101_problem as ref_resnet
from repro.core.problem import default_vgg19_problem as ref_vgg
from repro_torch.core import acquisition as port_acq
from repro_torch.core import gp as port_gp
from repro_torch.core import torch_cost
from repro_torch.core.problem import default_resnet101_problem as port_resnet
from repro_torch.core.problem import default_vgg19_problem as port_vgg
from repro_torch.interop import from_reference

torch.set_num_threads(1)
W = ref_acq.AcqWeights()
L_PAD = 37


@pytest.fixture(scope="module")
def case():
    """Two scenarios (VGG19 and ResNet101, padded to L=37) after their
    init design and its neighbour probes, fitted by the reference."""
    ref_pbs = [ref_vgg(), ref_resnet()]
    port_pbs = [port_vgg(), port_resnet()]
    cfg = ref_gp.GPConfig()
    states = []
    for seed, pb in enumerate(ref_pbs):
        st = RefState(pb, seed, 20, 9, 5, cfg, True, True)
        st.init_design()
        st.drain_probes()
        states.append(st)
    m = ref_gp.bucket_size(max(s.n_pts for s in states), cfg.max_points)
    data = {k: jnp.asarray(np.stack([s.dataset()[k][:m] for s in states]),
                           jnp.bool_ if k == "mask" else jnp.float32)
            for k in ("x", "y", "mask")}
    gps_r = ref_gp.fit_batch(data, cfg)
    grid = ref_acq.candidate_grid(64)
    cand = np.stack([ref_acq.assemble_candidates(
        st.pb, grid, st.best_a, True, boundary=st.boundary, l_pad=L_PAD)
        for st in states]).astype(np.float32)
    params_r = jax_cost.stack_params([pb.jax_params() for pb in ref_pbs],
                                     l_pad=L_PAD)
    t = [st.t_norm(True) for st in states]
    lanes = dict(
        bf=np.array([st.best_feasible() for st in states], np.float32),
        lb=np.array([ref_acq.schedule(W.lam_base0, W.lam_baseT, x)
                     for x in t], np.float32),
        lg=np.array([ref_acq.schedule(W.lam_g0, W.lam_gT, x) for x in t],
                    np.float32))
    return dict(
        gps_r=gps_r, gps_p=from_reference(jax.tree.map(np.asarray, gps_r),
                                          "cpu"),
        params_r=params_r,
        params_p=from_reference({k: np.asarray(v)
                                 for k, v in params_r.items()}, "cpu"),
        cand=cand, lanes=lanes, ref_pbs=ref_pbs, port_pbs=port_pbs,
        states=states)


def _ref_scores(c):
    pen = jax.vmap(jax_cost.penalty)(c["params_r"], jnp.asarray(c["cand"]))
    hs = jax.vmap(ref_acq.hybrid_scores,
                  in_axes=(0, 0, 0, 0, 0, 0, None, None, 0))
    return np.asarray(hs(c["gps_r"], jnp.asarray(c["cand"]),
                         jnp.asarray(c["lanes"]["bf"]), pen,
                         jnp.asarray(c["lanes"]["lb"]),
                         jnp.asarray(c["lanes"]["lg"]), jnp.float32(W.lam_p),
                         jnp.float32(W.beta), c["gps_r"]["y_sigma"]))


def _port_scores(c, fn):
    cand = torch.as_tensor(c["cand"])
    pen = torch_cost.penalty(c["params_p"], cand)
    return fn(c["gps_p"], cand, torch.as_tensor(c["lanes"]["bf"]), pen,
              torch.as_tensor(c["lanes"]["lb"]),
              torch.as_tensor(c["lanes"]["lg"]), W.lam_p, W.beta,
              c["gps_p"]["y_sigma"])


def test_block_scores_and_argmax_equal(case):
    ref = _ref_scores(case)
    got = _port_scores(case, port_acq.block_scores)
    assert got.shape == (2, 64 * 64 + L_PAD + port_acq.N_LOCAL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(torch.argmax(got, -1).numpy(),
                                  np.argmax(ref, -1))
    # the block path (kernel mean) and the differentiable expression agree
    plain = _port_scores(case, port_acq.hybrid_scores)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_refined_point_equal(case):
    a_r, s_r = ref_acq.maximize_batch(
        case["gps_r"], case["params_r"], jnp.asarray(case["cand"]),
        jnp.asarray(case["lanes"]["bf"]), jnp.asarray(case["lanes"]["lb"]),
        jnp.asarray(case["lanes"]["lg"]), jnp.float32(W.lam_p),
        jnp.float32(W.beta), jnp.float32(ref_acq.REFINE_LR),
        ref_acq.REFINE_STEPS)
    a_p, s_p = port_acq.maximize_batch(
        case["gps_p"], case["params_p"], torch.as_tensor(case["cand"]),
        torch.as_tensor(case["lanes"]["bf"]),
        torch.as_tensor(case["lanes"]["lb"]),
        torch.as_tensor(case["lanes"]["lg"]), W.lam_p, W.beta,
        port_acq.REFINE_LR, port_acq.REFINE_STEPS)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_r), atol=1e-4)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-4,
                               atol=1e-4)


def test_single_scenario_maximize_equal(case):
    """``maximize`` (one scenario, the sequential engine's call) on the
    first lane's GP."""
    st = case["states"][0]
    gp_r = jax.tree.map(lambda v: v[0], case["gps_r"])
    gp_p = port_gp.take_lanes(case["gps_p"], 0)
    grid = ref_acq.candidate_grid(64)
    kw = dict(t_norm=st.t_norm(True), best_feasible=st.best_feasible(),
              grid=grid, incumbent=st.best_a, boundary=st.boundary)
    a_r = ref_acq.maximize(gp_r, case["ref_pbs"][0], W, **kw)
    a_p = port_acq.maximize(gp_p, case["port_pbs"][0],
                            port_acq.AcqWeights(), **kw)
    assert a_p.dtype == np.float64 and a_p.shape == (2,)
    np.testing.assert_allclose(a_p, a_r, atol=1e-4)


def test_argmax_tie_and_nan_semantics():
    """First maximum wins and NaN counts as the maximum, on both sides."""
    rows = np.array([[1.0, 3.0, 3.0, 2.0],
                     [1.0, np.nan, 5.0, np.nan],
                     [-np.inf, -np.inf, -np.inf, -np.inf],
                     [0.0, 0.0, 0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(
        torch.argmax(torch.as_tensor(rows), dim=-1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)))
    np.testing.assert_array_equal(
        torch.argmax(torch.as_tensor(rows), dim=-1).numpy(), [1, 1, 0, 0])


def test_ei_ucb_schedule_equal():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal(50).astype(np.float32)
    sigma = np.abs(rng.standard_normal(50)).astype(np.float32)
    sigma[:5] = 0.0                                  # the sigma floor
    r = np.asarray(ref_acq.expected_improvement(
        jnp.asarray(mu), jnp.asarray(sigma), jnp.float32(0.3)))
    p = port_acq.expected_improvement(torch.as_tensor(mu),
                                      torch.as_tensor(sigma), 0.3)
    # erf differs in its last bits between the libraries: rtol 1e-5, and
    # atol 1e-6 where EI cancels to about zero
    np.testing.assert_allclose(p.numpy(), r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        port_acq.ucb(torch.as_tensor(mu), torch.as_tensor(sigma), 2.0),
        np.asarray(ref_acq.ucb(jnp.asarray(mu), jnp.asarray(sigma), 2.0)),
        rtol=1e-7)
    for t in (0.0, 0.3, 1.0):
        assert port_acq.schedule(1.0, 0.2, t) == ref_acq.schedule(1.0, 0.2,
                                                                   t)
    assert dataclasses.asdict(port_acq.AcqWeights()) == dataclasses.asdict(W)
    assert (port_acq.N_LOCAL, port_acq.REFINE_STEPS, port_acq.REFINE_LR) == (
        ref_acq.N_LOCAL, ref_acq.REFINE_STEPS, ref_acq.REFINE_LR)


def test_host_candidates_equal(case):
    grid = port_acq.candidate_grid(64)
    np.testing.assert_array_equal(grid, ref_acq.candidate_grid(64))
    for st, pb in zip(case["states"], case["port_pbs"]):
        for inc in (None, st.best_a):
            np.testing.assert_array_equal(
                port_acq.local_candidates(pb, inc),
                ref_acq.local_candidates(st.pb, inc))
            for aware in (True, False):
                np.testing.assert_array_equal(
                    port_acq.assemble_candidates(pb, grid, inc, aware,
                                                 l_pad=L_PAD),
                    ref_acq.assemble_candidates(st.pb, grid, inc, aware,
                                                l_pad=L_PAD))
